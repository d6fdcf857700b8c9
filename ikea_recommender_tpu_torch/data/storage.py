"""One file interface for local paths and object-store paths.

The port's own copy of ``ikea_recommender_tpu/data/storage.py`` (the
reference's ``Gfile``, ``ikea/data_utils/gfile.py:7-61``). ``gs://`` paths
need ``google-cloud-storage``, imported only when such a path is used;
every other path is a local file.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
from typing import List, Optional


def _is_gcs(path: str) -> bool:
    return path.startswith("gs://")


class Storage:
    def __init__(self, project: Optional[str] = None):
        self.project = project
        self._client = None

    # -- GCS plumbing (optional dependency) --------------------------------
    def _gcs(self):
        if self._client is None:
            try:
                from google.cloud import storage as gcs  # type: ignore
            except ImportError as exc:  # pragma: no cover
                raise RuntimeError(
                    "gs:// paths need google-cloud-storage, which is not "
                    "installed; stage the data locally instead"
                ) from exc
            self._client = gcs.Client(project=self.project)
        return self._client

    def _split_gcs(self, path: str):
        bucket, _, blob = path[len("gs://") :].partition("/")
        return bucket, blob

    # -- API ---------------------------------------------------------------
    def open(self, path: str, mode: str = "r"):
        if _is_gcs(path):  # pragma: no cover - needs GCS
            bucket, blob = self._split_gcs(path)
            return self._gcs().bucket(bucket).blob(blob).open(mode)
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        if _is_gcs(path):  # pragma: no cover - needs GCS
            bucket, blob = self._split_gcs(path)
            return self._gcs().bucket(bucket).blob(blob).exists()
        return os.path.exists(path)

    def copy(self, src: str, dst: str) -> None:
        if not _is_gcs(src) and not _is_gcs(dst):
            os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
            shutil.copy(src, dst)
            return
        with self.open(src, "rb") as fin, self.open(dst, "wb") as fout:  # pragma: no cover
            shutil.copyfileobj(fin, fout)

    def list_files(self, prefix: str) -> List[str]:
        """The files under a directory, or whose paths start with
        ``prefix``, sorted."""
        if _is_gcs(prefix):  # pragma: no cover - needs GCS
            bucket, blob_prefix = self._split_gcs(prefix)
            blobs = self._gcs().list_blobs(bucket, prefix=blob_prefix)
            return [f"gs://{bucket}/{b.name}" for b in blobs]
        if os.path.isdir(prefix):
            return sorted(os.path.join(prefix, f) for f in os.listdir(prefix))
        return sorted(glob.glob(prefix + "*"))

    def makedirs(self, path: str) -> None:
        if not _is_gcs(path):
            os.makedirs(path, exist_ok=True)


def load_json_gz_records(path: str, storage: Optional[Storage] = None) -> list:
    """Session records, one JSON object a line, gzip-compressed where the
    path ends in ``.gz`` (reference ``ikea/data_utils/utils.py:90-103``)."""
    storage = storage or Storage()
    with storage.open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".gz"):
        raw = gzip.decompress(raw)
    text = raw.decode() if isinstance(raw, bytes) else raw
    return [json.loads(line) for line in text.splitlines() if line.strip()]
