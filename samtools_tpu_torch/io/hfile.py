"""Remote inputs: URL → local path resolution (hfile analog).

htslib reaches remote data through its hfile plugin stack (libcurl,
S3, GCS); samtools itself just opens "paths" that may be URLs
(SURVEY §1 L0 table).  The rebuild keeps the same seam: any tool input
that looks like a URL is fetched once into a local cache file and the
local path flows through the normal columnar readers.  Supported
schemes: http://, https://, ftp:// (urllib), file://.

The cache lives under $SAMTPU_CACHE (default: a per-user tmp dir) keyed
by URL hash, mirroring REF_CACHE's download-once behavior; index
sidecar files (.bai/.crai/.fai/...) are fetched on demand by the same
rule because callers derive their names from the returned path's stem
only when the remote sidecar exists.  Counterpart of
samtools_tpu/io/hfile.py.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile

_SCHEMES = ("http://", "https://", "ftp://")


def is_remote(path: str) -> bool:
    return isinstance(path, str) and (path.startswith(_SCHEMES)
                                      or path.startswith("file://"))


def _cache_dir() -> str:
    d = os.environ.get("SAMTPU_CACHE")
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         "samtpu_cache_%d" % os.getuid())
    os.makedirs(d, exist_ok=True)
    return d


def resolve(path: str, quiet: bool = True) -> str:
    """Return a local filesystem path for ``path``; remote URLs are
    downloaded into the cache once (subsequent opens reuse the copy).
    Raises OSError on fetch failure so callers surface their usual
    "failed to open" error text."""
    if not is_remote(path):
        return path
    if path.startswith("file://"):
        return path[7:]
    key = hashlib.sha256(path.encode()).hexdigest()[:32]
    base = os.path.basename(path.split("?", 1)[0]) or "remote"
    local = os.path.join(_cache_dir(), key + "-" + base)
    if os.path.exists(local) and os.path.getsize(local) > 0:
        return local
    import urllib.error
    import urllib.request
    tmp = local + ".part.%d" % os.getpid()
    try:
        if not quiet:
            sys.stderr.write("[hfile] fetching %s\n" % path)
        with urllib.request.urlopen(path) as r, open(tmp, "wb") as out:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        os.replace(tmp, local)
        return local
    except urllib.error.URLError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise OSError(str(e.reason) if hasattr(e, "reason") else str(e))
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def try_sidecar(url: str, suffix: str) -> str | None:
    """Fetch url+suffix (e.g. '.bai') if it exists remotely; None
    otherwise."""
    try:
        return resolve(url + suffix)
    except OSError:
        return None
