"""Atomic directory creation: build into a temporary sibling, rename into
place on success, clean up on failure (the port's own copy of
`seesaw_tpu/utils/transactional.py`).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import uuid
from pathlib import Path


@contextlib.contextmanager
def transactional_folder(final_path: str | Path, force: bool = False):
    final_path = Path(final_path)
    if final_path.exists():
        if force:
            shutil.rmtree(final_path)
        else:
            raise FileExistsError(f"{final_path} exists (use force=True)")
    final_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = final_path.parent / f".tmp.{final_path.name}.{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    try:
        yield str(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    os.rename(tmp, final_path)
