"""Hub repo ids resolved against the local Hugging Face cache, offline,
and a folder pushed to the hub.

Port of `tdm_tpu/io/hub.py`: `from_pretrained(
"PixArt-alpha/PixArt-XL-2-512x512")` finds the checkout in the standard
huggingface_hub cache layout

    <cache>/models--{org}--{name}/
        refs/<revision>            a file holding a commit hash
        snapshots/<commit>/...     the checkout

and nothing here reaches the network: a repo id that is not cached raises
the JAX package's offline error, naming where the checkout was expected.
`push_to_hub` uploads a folder through `huggingface_hub.HfApi` (the
trainer's `--push_to_hub`); it is the one function here that needs the
network and that package.
"""

from __future__ import annotations

import os
import re
from typing import Optional

_REPO_ID_RE = re.compile(r"^[\w.\-]+/[\w.\-]+$")
_COMMIT_RE = re.compile(r"^[0-9a-f]{40}$")


def hub_cache_dir() -> str:
    """The huggingface_hub cache root, with the standard overrides
    (HF_HUB_CACHE > HF_HOME/hub > ~/.cache/huggingface/hub)."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def repo_cache_dir(repo_id: str, *, cache_dir: Optional[str] = None) -> str:
    """`org/name` → `<cache>/models--org--name` (no existence check)."""
    return os.path.join(cache_dir or hub_cache_dir(), f"models--{repo_id.replace('/', '--')}")


def cached_snapshot(
    repo_id: str,
    *,
    revision: Optional[str] = None,
    cache_dir: Optional[str] = None,
) -> Optional[str]:
    """`repo_id`@`revision` → its local snapshot directory, or None:
      1. a full 40-hex `revision` → snapshots/<revision>;
      2. refs/<revision or 'main'> names a commit → snapshots/<commit>;
      3. no ref, `revision` not pinned, snapshots present → the most recently
         modified snapshot (a cache filled by hand or rsync)."""
    repo_dir = repo_cache_dir(repo_id, cache_dir=cache_dir)
    snap_root = os.path.join(repo_dir, "snapshots")
    if revision and _COMMIT_RE.match(revision):
        path = os.path.join(snap_root, revision)
        return path if os.path.isdir(path) else None
    ref = os.path.join(repo_dir, "refs", revision or "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
        path = os.path.join(snap_root, commit)
        if os.path.isdir(path):
            return path
    if revision is None and os.path.isdir(snap_root):
        snaps = [os.path.join(snap_root, d) for d in os.listdir(snap_root)
                 if os.path.isdir(os.path.join(snap_root, d))]
        if snaps:
            return max(snaps, key=os.path.getmtime)
    return None


def resolve_pretrained(
    name_or_path: str,
    *,
    revision: Optional[str] = None,
    cache_dir: Optional[str] = None,
) -> str:
    """A local path or an `org/name` repo id → a local directory: an
    existing path comes back unchanged, a repo id resolves against the hub
    cache (`cached_snapshot`), and anything else raises FileNotFoundError
    (the port never downloads)."""
    if os.path.exists(name_or_path):
        return name_or_path
    if not _REPO_ID_RE.match(name_or_path):
        raise FileNotFoundError(
            f"{name_or_path!r} is neither an existing path nor an 'org/name' hub repo id"
        )
    snap = cached_snapshot(name_or_path, revision=revision, cache_dir=cache_dir)
    if snap is not None:
        return snap
    raise FileNotFoundError(
        f"{name_or_path!r} is not in the hub cache "
        f"({repo_cache_dir(name_or_path, cache_dir=cache_dir)}) and "
        "downloads are disabled (the port never downloads). "
        "Populate the cache on a connected host (huggingface-cli "
        "download) or pass a local directory."
    )


def push_to_hub(
    folder: str,
    repo_id: str,
    *,
    token: Optional[str] = None,
    private: bool = True,
    commit_message: str = "tdm_tpu checkpoint",
) -> str:
    """Create `repo_id` if needed and upload `folder` to it; returns the
    repo id the hub reports. Needs a token (`token`, else $HF_TOKEN) and the
    `huggingface_hub` package; either missing raises RuntimeError."""
    token = token or os.environ.get("HF_TOKEN")
    if not token:
        raise RuntimeError(
            "push_to_hub needs a token: pass token= or set HF_TOKEN "
            "(reference flag --hub_token, src/args.py)"
        )
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("huggingface_hub is not installed") from e
    api = HfApi(token=token)
    url = api.create_repo(repo_id, exist_ok=True, private=private).repo_id
    api.upload_folder(repo_id=repo_id, folder_path=folder, commit_message=commit_message)
    return url
