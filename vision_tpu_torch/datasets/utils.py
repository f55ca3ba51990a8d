"""Dataset integrity, archive and argument helpers (reference
``torchvision/datasets/utils.py``; the port's copy of
``vision_tpu/datasets/utils.py``). The ``download_*`` functions keep their
signatures; a checkout that runs offline places the files by hand."""

from __future__ import annotations

import gzip
import hashlib
import lzma
import os
import tarfile
import urllib.request
import zipfile
from typing import Optional

__all__ = [
    "calculate_md5",
    "check_integrity",
    "check_md5",
    "download_and_extract_archive",
    "download_file_from_google_drive",
    "download_url",
    "extract_archive",
    "iterable_to_str",
    "list_dir",
    "list_files",
    "path_or_str",
    "verify_str_arg",
]


def calculate_md5(fpath: str, chunk_size: int = 1024 * 1024) -> str:
    """reference ``datasets/utils.py:35``."""
    md5 = hashlib.md5(usedforsecurity=False)
    with open(fpath, "rb") as f:
        while chunk := f.read(chunk_size):
            md5.update(chunk)
    return md5.hexdigest()


def check_md5(fpath: str, md5: str) -> bool:
    return md5 == calculate_md5(fpath)


def check_integrity(fpath: str, md5: Optional[str] = None) -> bool:
    """reference ``datasets/utils.py:58``: the file exists and, where
    ``md5`` is given, has that digest."""
    if not os.path.isfile(fpath):
        return False
    if md5 is None:
        return True
    return check_md5(fpath, md5)


def download_url(url: str, root: str, filename: Optional[str] = None,
                 md5: Optional[str] = None) -> None:
    """reference ``datasets/utils.py:87`` (no Google Drive path). A file
    already there with the right digest is kept."""
    root = os.path.expanduser(root)
    if filename is None:
        filename = os.path.basename(url)
    fpath = os.path.join(root, filename)
    os.makedirs(root, exist_ok=True)
    if check_integrity(fpath, md5):
        return
    try:
        urllib.request.urlretrieve(url, fpath)
    except Exception as e:
        raise RuntimeError(f"failed to download {url}: {e}") from e
    if not check_integrity(fpath, md5):
        raise RuntimeError(f"downloaded file {fpath} failed md5 check")


def _extract_tar(from_path, to_path):
    with tarfile.open(from_path) as tar:
        tar.extractall(to_path, filter="data")


def _extract_zip(from_path, to_path):
    with zipfile.ZipFile(from_path) as z:
        z.extractall(to_path)


def _decompress(from_path, to_path, opener):
    with opener(from_path, "rb") as src, open(to_path, "wb") as dst:
        while chunk := src.read(1024 * 1024):
            dst.write(chunk)


def extract_archive(from_path: str, to_path: Optional[str] = None,
                    remove_finished: bool = False) -> str:
    """reference ``datasets/utils.py:326``: tar (plain, gz, xz, bz2), zip,
    gz and xz by suffix. Returns ``to_path``."""
    if to_path is None:
        to_path = os.path.dirname(from_path)
    name = os.path.basename(from_path)
    if name.endswith((".tar", ".tar.gz", ".tgz", ".tar.xz", ".tar.bz2")):
        _extract_tar(from_path, to_path)
    elif name.endswith(".zip"):
        _extract_zip(from_path, to_path)
    elif name.endswith(".gz"):
        _decompress(from_path, os.path.join(to_path, name[:-len(".gz")]), gzip.open)
    elif name.endswith(".xz"):
        _decompress(from_path, os.path.join(to_path, name[:-len(".xz")]), lzma.open)
    else:
        raise ValueError(f"unsupported archive {name}")
    if remove_finished:
        os.remove(from_path)
    return to_path


def download_and_extract_archive(url: str, download_root: str,
                                 extract_root: Optional[str] = None,
                                 filename: Optional[str] = None,
                                 md5: Optional[str] = None,
                                 remove_finished: bool = False) -> None:
    if extract_root is None:
        extract_root = download_root
    if filename is None:
        filename = os.path.basename(url)
    download_url(url, download_root, filename, md5)
    extract_archive(os.path.join(download_root, filename), extract_root,
                    remove_finished)


def download_file_from_google_drive(file_id, root, filename=None, md5=None):
    """reference ``utils.py:172``: Google Drive's token handling needs the
    gdown package, which the port does not use; place the file by hand."""
    raise RuntimeError(
        "Google Drive downloads require the gdown package (not used by the "
        f"port); place the file manually under {root}")


def list_dir(root: str, prefix: bool = False):
    dirs = [d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))]
    return [os.path.join(root, d) for d in dirs] if prefix else dirs


def list_files(root: str, suffix: str, prefix: bool = False):
    files = [f for f in os.listdir(root)
             if os.path.isfile(os.path.join(root, f)) and f.endswith(suffix)]
    return [os.path.join(root, f) for f in files] if prefix else files


def verify_str_arg(value, arg=None, valid_values=None, custom_msg=None):
    """reference ``datasets/utils.py`` verify_str_arg."""
    if not isinstance(value, str):
        raise ValueError(f"{arg} should be a str, got {type(value)}")
    if valid_values is not None and value not in valid_values:
        raise ValueError(
            custom_msg
            or f"Unknown value '{value}' for argument {arg}. Valid values are "
            f"{{{', '.join(valid_values)}}}.")
    return value


def iterable_to_str(iterable) -> str:
    return "'" + "', '".join(str(item) for item in iterable) + "'"


def path_or_str(path):
    """A ``PathLike`` as ``str``; anything else as it is."""
    return os.fspath(path) if hasattr(path, "__fspath__") else path
