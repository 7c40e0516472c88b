"""Pretrained-weight store: resolve, sha1-verify and cache ``.params``
files (counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py``;
reference ``python/mxnet/gluon/model_zoo/model_store.py``).

``get_model_file(name)`` is ``{root}/{name}-{short_hash}.params``, its
sha1 checked against the table (:func:`register` adds to it; it starts
empty, as the reference's, since no converted weights are published). A
missing or corrupt file is copied from the repo ``$MXNET_GLUON_REPO`` when
that is a ``file://`` URL or a directory (``gluon/models/{file}.params``
or ``.zip`` under it, as the reference's layout). Nothing is fetched over
a network: an ``http(s)://`` repo is refused, and a file found nowhere
raises :class:`MXNetError` naming the paths looked at.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import zipfile
from urllib.parse import urlparse

from ...base import MXNetError

__all__ = ["get_model_file", "purge", "register", "check_sha1", "short_hash"]

# name -> sha1 of the .params file (reference: model_store.py::_model_sha1)
_model_sha1: dict = {}


def register(name: str, sha1: str) -> None:
    """Register (or update) the pinned sha1 for a model name."""
    _model_sha1[name] = sha1


def short_hash(name: str) -> str:
    """First 8 hex chars of the registered sha1 (the cache-file tag)."""
    if name not in _model_sha1:
        raise MXNetError(
            f"Pretrained model for {name!r} is not available: no sha1 "
            "registered (model_store.register(name, sha1) with the sha1 of "
            "a .params file you have)")
    return _model_sha1[name][:8]


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """True iff the file's sha1 matches (reference: check_sha1)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1 << 20)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def _local_repo():
    """The repo directory of ``$MXNET_GLUON_REPO`` (a ``file://`` URL or
    a path), or None when unset; a network URL is refused."""
    repo = os.environ.get("MXNET_GLUON_REPO")
    if not repo:
        return None
    url = urlparse(repo)
    if url.scheme == "file":
        return url.path
    if url.scheme == "":
        return repo
    raise MXNetError(
        f"MXNET_GLUON_REPO={repo!r}: the model store fetches nothing over "
        "a network; give a file:// URL or a directory holding "
        "gluon/models/<name>-<hash>.params")


def get_model_file(name: str, root: str = os.path.join("~", ".mxnet",
                                                       "models")) -> str:
    """The verified local path of ``name``'s ``.params`` file:
    ``{root}/{name}-{short_hash}.params`` when its sha1 matches, else a
    copy from the local repo (``.params`` first, then the ``.zip``
    wrapping), verified again."""
    file_name = f"{name}-{short_hash(name)}"
    root = os.path.expanduser(root)
    file_path = os.path.join(root, file_name + ".params")
    sha1 = _model_sha1[name]
    looked = [file_path]
    if os.path.exists(file_path):
        if check_sha1(file_path, sha1):
            return file_path
        corrupt = file_path
    else:
        corrupt = None
    repo = _local_repo()
    if repo is not None:
        for suffix in (".params", ".zip"):
            src = os.path.join(repo, "gluon", "models", file_name + suffix)
            looked.append(src)
            if not os.path.exists(src):
                continue
            os.makedirs(root, exist_ok=True)
            if suffix == ".zip":
                with zipfile.ZipFile(src) as zf:
                    for member in zf.namelist():
                        dest = os.path.realpath(os.path.join(root, member))
                        if not dest.startswith(os.path.realpath(root)
                                               + os.sep):
                            raise MXNetError(
                                f"repo zip for {name} holds an unsafe "
                                f"member path {member!r}")
                    zf.extractall(root)
                if not os.path.exists(file_path):
                    raise MXNetError(f"repo zip {src} does not hold "
                                     f"{os.path.basename(file_path)}")
            else:
                tmp = file_path + ".part"
                shutil.copyfile(src, tmp)
                os.replace(tmp, file_path)
            if check_sha1(file_path, sha1):
                return file_path
            raise MXNetError(
                f"{src} for {name} has a sha1 other than the registered "
                f"{sha1}: the repo's file is corrupt")
    if corrupt is not None:
        raise MXNetError(
            f"{corrupt} for {name} has a sha1 other than the registered "
            f"{sha1} (a corrupt or stale file), and no repo holds a good "
            f"copy (looked at {looked})")
    raise MXNetError(
        f"pretrained weights for {name!r} not found: looked at {looked}. "
        "Nothing is downloaded; put the .params file there (or set "
        "MXNET_GLUON_REPO to a directory holding gluon/models/)")


def purge(root: str = os.path.join("~", ".mxnet", "models")) -> None:
    """Delete all cached ``.params`` files (reference: purge)."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
