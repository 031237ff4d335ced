"""Artifact code-hash versioning.

The code-hash half of ``stamp_tpu/utils/cache.py`` (``get_processing_code_hash``
and its file digest), copied so that the port imports nothing of the JAX
package.  The weight-download cache of that module has no caller in the
port: its extractors read pre-seeded weight files only.
"""

import hashlib
from functools import cache
from pathlib import Path


def _sha256(path: Path) -> "hashlib._Hash":
    with path.open("rb") as fp:
        return hashlib.file_digest(fp, "sha256")


@cache
def get_processing_code_hash(file_path: Path) -> str:
    """Combined hash of every ``*.py`` source sitting next to ``file_path``.

    Output artifact directories carry the first characters of this value
    (e.g. ``uni2-<hash8>/``), making features extracted by different code
    versions distinguishable after the fact.
    """
    combined = hashlib.sha256()
    for source in sorted(file_path.parent.glob("*.py")):
        combined.update(_sha256(source).digest())
    return combined.hexdigest()
