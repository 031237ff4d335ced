"""The port's h5py-free ``.h5`` writer (stamp_tpu_torch.io.h5) against the
JAX package's h5py writer: h5py and stamp_tpu's readers must see the same
datasets, attrs and attr types in both files."""

import h5py
import numpy as np
import pytest

from stamp_tpu.io.h5 import read_feats
from stamp_tpu.io.h5 import write_tile_feats_atomic as jax_write
from stamp_tpu_torch.io import h5 as torch_h5


def _write_both(tmp_path, n: int, dim: int, precision):
    rng = np.random.default_rng(n)
    kwargs = dict(
        feats=rng.normal(size=(n, dim)).astype(np.float16),
        coords_um=(rng.integers(0, 40, (n, 2)) * 256.0).astype(np.float32),
        extractor_id="uni2",
        tile_size_um=256.0,
        tile_size_px=224,
        code_hash="0123abcd",
        precision=precision,
    )
    jax_write(output_path=tmp_path / "jax.h5", **kwargs)
    torch_h5.write_tile_feats_atomic(output_path=tmp_path / "torch.h5", **kwargs)
    return kwargs


@pytest.mark.parametrize(
    "n,dim,precision", [(1, 8, None), (144, 1536, None), (37, 2560, "int8")]
)
def test_h5py_reads_the_same_file(tmp_path, n, dim, precision):
    kwargs = _write_both(tmp_path, n, dim, precision)
    with h5py.File(tmp_path / "jax.h5") as ref, h5py.File(tmp_path / "torch.h5") as got:
        assert set(got) == set(ref) == {"coords", "feats"}
        for name in ref:
            assert got[name].dtype == ref[name].dtype
            np.testing.assert_array_equal(got[name][()], ref[name][()])
        assert dict(got.attrs) == dict(ref.attrs)
        for key, value in ref.attrs.items():
            assert type(got.attrs[key]) is type(value), key
    np.testing.assert_array_equal(
        h5py.File(tmp_path / "torch.h5")["feats"][()], kwargs["feats"]
    )


def test_stamp_tpu_reader_takes_port_files(tmp_path):
    _write_both(tmp_path, 20, 64, None)
    ref_feats, ref_coords = read_feats(tmp_path / "jax.h5")
    feats, coords = read_feats(tmp_path / "torch.h5")
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(coords.coords_um, ref_coords.coords_um)
    assert (coords.tile_size_um, coords.tile_size_px) == (
        ref_coords.tile_size_um,
        ref_coords.tile_size_px,
    )


def test_read_h5_round_trip(tmp_path):
    kwargs = _write_both(tmp_path, 9, 16, "int8")
    datasets, attrs = torch_h5.read_h5(tmp_path / "torch.h5")
    np.testing.assert_array_equal(datasets["feats"], kwargs["feats"])
    np.testing.assert_array_equal(datasets["coords"], kwargs["coords_um"])
    with h5py.File(tmp_path / "jax.h5") as ref:
        assert attrs == dict(ref.attrs)


def test_read_h5_checks_checksums(tmp_path):
    _write_both(tmp_path, 4, 8, None)
    path = tmp_path / "torch.h5"
    raw = bytearray(path.read_bytes())
    raw[60] ^= 0xFF  # inside the root object header
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        torch_h5.read_h5(path)


@pytest.mark.parametrize(
    "data,initval,expected",
    [(b"", 0, 0xDEADBEEF), (b"Four score and seven years ago", 0, 0x17770551),
     (b"Four score and seven years ago", 1, 0xCD628161)],
)  # fmt: skip
def test_lookup3_reference_values(data, initval, expected):
    """Published test vectors of Jenkins' lookup3 hashlittle."""
    assert torch_h5.lookup3(data, initval) == expected


def test_unsupported_dtype_raises(tmp_path):
    with pytest.raises(TypeError):
        torch_h5.write_h5(tmp_path / "x.h5", {"x": np.zeros(3, np.complex64)}, {})
    assert not (tmp_path / "x.h5").exists()
