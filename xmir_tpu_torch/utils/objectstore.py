"""Object-store upload of gallery originals (port of
xmir_tpu/utils/objectstore.py).

The reference uploads each ingested gallery image to S3 and records the
``s3://bucket/key`` URI as the image path in Milvus, so that a serving front
end can fetch originals (ingest_embeddings.py:319-383). Here the same contract
is a pluggable store:

  LocalDirStore   copies originals under a destination directory (also what
                  a mounted bucket looks like to the ingest job)
  S3Store         boto3's ``upload_file``, credentials resolved as the
                  reference does (argument, then environment); boto3 is
                  imported only when an S3 store is made

``resolve_store("s3://bucket")`` or ``resolve_store("/some/dir")`` picks the
store; ``upload_originals`` returns the stored URIs, which the index keeps as
its paths.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Sequence


class LocalDirStore:
    """Copy originals into a destination directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def upload(self, local_path: str, key: str) -> str:
        dest = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        shutil.copyfile(local_path, dest)
        return dest


class S3Store:
    """boto3-backed store (reference build_s3_client / upload_images_to_s3).
    Explicit arguments win, then AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY /
    AWS_REGION."""

    def __init__(self, bucket: str, access_key_id: Optional[str] = None,
                 secret_access_key: Optional[str] = None, region: Optional[str] = None):
        try:
            import boto3
        except ImportError as e:
            raise ImportError(
                "boto3 is required for S3 uploads. Install it with `pip install boto3`."
            ) from e
        access_key_id = access_key_id or os.getenv("AWS_ACCESS_KEY_ID")
        secret_access_key = secret_access_key or os.getenv("AWS_SECRET_ACCESS_KEY")
        region = region or os.getenv("AWS_REGION")
        if not access_key_id or not secret_access_key or not region:
            raise ValueError(
                "Missing AWS S3 credentials. Provide them explicitly or set "
                "AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_REGION.")
        self.bucket = bucket
        self._client = boto3.client("s3", aws_access_key_id=access_key_id,
                                    aws_secret_access_key=secret_access_key, region_name=region)

    def upload(self, local_path: str, key: str) -> str:
        self._client.upload_file(local_path, self.bucket, key)
        return f"s3://{self.bucket}/{key}"


def resolve_store(dest: str):
    """'s3://bucket' -> S3Store(bucket); anything else -> LocalDirStore."""
    if dest.startswith("s3://"):
        bucket = dest[len("s3://"):].strip("/")
        if "/" in bucket:
            raise ValueError("pass the prefix via upload_originals(prefix=...), not the "
                             "bucket URI")
        return S3Store(bucket)
    return LocalDirStore(dest)


def upload_originals(image_paths: Sequence[str], store, prefix: str = "original") -> List[str]:
    """Upload every original and return the stored URIs, in order. A key is
    the path relative to the images' common root (so that same-named files
    in different subdirectories cannot overwrite each other); with every
    image in one directory it is the reference's prefix/basename."""
    prefix = prefix.strip("/")
    dirs = {os.path.dirname(os.path.abspath(p)) for p in image_paths}
    common = os.path.commonpath(sorted(dirs)) if dirs else ""
    stored = []
    for p in image_paths:
        rel = os.path.relpath(os.path.abspath(p), common).replace(os.sep, "/")
        stored.append(store.upload(p, f"{prefix}/{rel}" if prefix else rel))
    return stored
