"""Host → device prefetching for the training feed.

Counterpart of ``stamp_tpu/parallel/prefetch.py:20``: a producer thread
builds the batches (h5 reads, bag sampling, stacking) in the order the
synchronous feed would — so the draws from ``Seed.numpy_rng()`` stay in
the same order — and copies them to the device ahead of the step.

On a card the copy goes from pinned memory on a side CUDA stream; the
consumer's stream waits on that copy's event, and each tensor is marked
(``record_stream``) as used by the consumer's stream, so the caching
allocator does not hand its memory out while the step still reads it.
The producer thread sets its own CUDA device: the caller's device context
does not reach a new thread.  On the CPU it only overlaps the host work.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterable, Iterator, Mapping
from typing import Any

import numpy as np
import torch

_SENTINEL = object()


def _map(tree: Any, fn) -> Any:
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _tensors(tree: Any) -> list[torch.Tensor]:
    found: list[torch.Tensor] = []
    _map(tree, lambda t: found.append(t) if isinstance(t, torch.Tensor) else None)
    return found


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def prefetch_to_device(iterable: Iterable[Any], *, size: int = 2, device: torch.device | str | None = None) -> Iterator[Any]:
    """Yield the batches of ``iterable`` (numpy arrays or tensors in tuples,
    lists and dicts; None passes) as tensors on ``device`` (default: the
    CPU), with at most ``size`` built but not yet handed out.  An exception
    in the producer is raised again here."""
    device = torch.device("cpu" if device is None else device)
    on_card = device.type == "cuda"
    q: queue.Queue = queue.Queue()
    slots = threading.Semaphore(size)
    stop = threading.Event()
    error: list[BaseException] = []

    def producer() -> None:
        try:
            stream = None
            if on_card:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            it = iter(iterable)
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if stream is None:
                    q.put((_map(batch, lambda x: _as_tensor(x).to(device)), None))
                    continue
                with torch.cuda.stream(stream):
                    moved = _map(batch, lambda x: _as_tensor(x).pin_memory().to(device, non_blocking=True))
                    copied = torch.cuda.Event()
                    copied.record(stream)
                q.put((moved, copied))
        except BaseException as e:  # noqa: BLE001 — raised again on the consumer's side
            error.append(e)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while (item := q.get()) is not _SENTINEL:
            moved, copied = item
            slots.release()
            if copied is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copied)
                for t in _tensors(moved):
                    t.record_stream(current)
            yield moved
    finally:
        stop.set()
        slots.release()  # a producer waiting for a slot sees the stop
        thread.join()
    if error:
        raise error[0]
