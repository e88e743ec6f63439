"""Checkpoint validation, fingerprints and the newest-valid-checkpoint
lookup.

Counterpart of the checkpoint helpers of ``deeplearning4j_tpu/train/
faults.py`` (``validate_checkpoint`` ``:380``, ``checkpoint_fingerprint``
``:515``, ``latest_valid_checkpoint`` ``:543`` and what they use), which
the serving engine's ``from_checkpoint`` and ``reload`` resolve through.
The fault policy, the non-finite guard, fault injection and the elastic
driver come with the training-infrastructure slice (ROADMAP § A); so does
the flight recorder, so a skipped checkpoint is reported by a warning only.
"""

from __future__ import annotations

import os
import uuid
import warnings
import zipfile
from typing import List, Optional, Tuple

_TMP_MARKER = ".tmp-"


def atomic_tmp_path(path: str) -> str:
    """Same-directory staging name for an atomic ``os.replace`` publish
    (rename is only atomic within a filesystem)."""
    return f"{path}{_TMP_MARKER}{os.getpid()}-{uuid.uuid4().hex[:8]}"


def validate_checkpoint(path: str) -> Tuple[bool, str]:
    """(ok, reason). Detects truncation (zip central directory gone), CRC
    corruption, and zips that are not model checkpoints (required entries
    missing)."""
    from deeplearning4j_tpu_torch.train.model_serializer import (
        COEFFICIENTS_ENTRY,
        CONFIG_ENTRY,
    )

    if not os.path.isfile(path):
        return False, "not a file"
    try:
        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            missing = {CONFIG_ENTRY, COEFFICIENTS_ENTRY} - names
            if missing:
                return False, (f"missing checkpoint entries {sorted(missing)}"
                               f" (found {sorted(names)})")
            bad = z.testzip()  # CRC over every member
            if bad is not None:
                return False, f"CRC mismatch in entry {bad!r}"
    except (zipfile.BadZipFile, OSError, EOFError) as e:
        return False, f"unreadable zip ({type(e).__name__}: {e})"
    return True, "ok"


def checkpoint_files(directory: str) -> List[str]:
    """Checkpoint candidates in ``directory``, oldest -> newest (mtime, then
    name). Staging files of in-flight or crashed atomic writes are never
    candidates."""
    out = []
    for name in os.listdir(directory):
        if _TMP_MARKER in name or not name.endswith((".zip", ".bin")):
            continue
        p = os.path.join(directory, name)
        try:
            # stat now, not in the sort key: a concurrent prune may delete
            # entries between listdir and the sort
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        if os.path.isfile(p):
            out.append((mtime, p))
    return [p for _, p in sorted(out)]


def checkpoint_fingerprint(path: str) -> Tuple[int, int]:
    """Cheap identity of a checkpoint's on-disk content: ``(mtime_ns,
    size)``. Atomic publishes change both together, so an unchanged
    fingerprint means an unchanged checkpoint (the engine's ``reload``
    then does nothing)."""
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


def latest_valid_checkpoint(directory: str, missing_ok: bool = False
                            ) -> Optional[str]:
    """Newest checkpoint in ``directory`` that passes validation, warning
    about (and skipping) corrupt or truncated newer ones. Raises
    FileNotFoundError when no valid checkpoint exists (``missing_ok=True``
    returns None instead)."""
    candidates = checkpoint_files(directory) if os.path.isdir(directory) else []
    if not candidates:
        if missing_ok:
            return None
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    for path in reversed(candidates):
        ok, reason = validate_checkpoint(path)
        if ok:
            return path
        warnings.warn(f"skipping corrupt checkpoint {path!r}: {reason}; "
                      "falling back to the previous one", stacklevel=2)
    if missing_ok:
        return None
    raise FileNotFoundError(
        f"no VALID checkpoint in {directory!r} "
        f"({len(candidates)} candidates, all corrupt)")
