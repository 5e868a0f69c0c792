"""Build the native C++ components on demand.

The port keeps its own copies of the sources in ``ray_tpu_torch/src/``
(the object-store arena, the spec codec, the event loop, the
scheduler, the compiled-DAG channel ring) and builds them into
``build/ray_tpu_torch/native/`` beside the package's parent directory,
never into ray_tpu's ``ray_tpu/_native/``. Where that directory cannot
be written (an install in a read-only site-packages), the build goes to
a per-user cache, ``$XDG_CACHE_HOME/ray_tpu_torch/`` (``~/.cache`` when
unset), instead (``build_dir``). The compiled artifacts are
intentionally NOT committed — platform-specific binaries
in a source tree drift from their sources and are a supply-chain hazard.
Instead they are (re)built from ``ray_tpu_torch/src/`` via make whenever a consumer
finds them missing or older than their sources (reference analogue: the
reference builds its C++ core through Bazel at install time, never
vendoring binaries).

Concurrency: loaders run at import time in every worker process, so the
stale-check + make is serialized under an exclusive flock on a lockfile
next to the artifacts. A process that loses the race blocks until the
winner's build completes, then sees finished files — no half-written ELF
is ever dlopen'd.
"""

import os
import subprocess
import threading

_lock = threading.Lock()
_done = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "src")


def _writable(path: str) -> bool:
    """Whether ``path`` is, or can be made, a directory this process
    writes into: its nearest existing ancestor is a directory we may
    write (a file in the way counts as not writable)."""
    probe = path
    while not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            return False
        probe = parent
    return os.path.isdir(probe) and os.access(probe, os.W_OK | os.X_OK)


def build_dir(*parts: str, pkg: str = _PKG) -> str:
    """``build/ray_tpu_torch/<parts>`` beside the package's parent
    directory (a checkout's root), or the same ``parts`` under the
    per-user cache when that cannot be written (an installed package)."""
    beside = os.path.join(os.path.dirname(pkg), "build", "ray_tpu_torch", *parts)
    if _writable(beside):
        return beside
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "ray_tpu_torch", *parts)


_OUT = build_dir("native")

_TARGETS = ("libobjstore.so", "libsched.so", "libchannel.so")


def _targets() -> tuple:
    """CPython extensions (_specenc.so, _evloop.so) join the target set
    only where the Python dev headers exist — their make rules skip
    otherwise, and treating them as required would flag every build
    stale forever."""
    import shutil

    if shutil.which("python3-config"):
        return _TARGETS + ("_specenc.so", "_evloop.so")
    return _TARGETS


def _stale() -> bool:
    try:
        newest_src = max(
            os.path.getmtime(os.path.join(root, f))
            for root, _, files in os.walk(_SRC) for f in files
            if f.endswith((".cc", ".h", ".c")))
    except ValueError:
        return False  # no sources (installed wheel) — nothing to build
    for t in _targets():
        p = os.path.join(_OUT, t)
        if not os.path.exists(p) or os.path.getmtime(p) < newest_src:
            return True
    return False


def ensure_native(quiet: bool = True) -> bool:
    """Build ray_tpu_torch/src/ -> ``_OUT`` if missing/stale. Returns True if
    the artifacts exist afterwards. Never raises: callers have graceful
    pure-Python fallbacks."""
    global _done
    if os.environ.get("RAY_TPU_NATIVE", "1").lower() in ("0", "false",
                                                         "no"):
        # Kill switch for the whole native lane: consumers (wirefmt's
        # codec, native_sched, ...) fall back to pure Python. Lets CI
        # exercise the fallback paths on a box that HAS a compiler.
        return False
    with _lock:
        if _done:
            return all(os.path.exists(os.path.join(_OUT, t))
                       for t in _targets())
        if not os.path.isdir(_SRC):
            _done = True
            return False
        os.makedirs(_OUT, exist_ok=True)
        try:
            import fcntl

            lockfile = os.path.join(_OUT, ".build.lock")
            with open(lockfile, "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    if _stale():
                        subprocess.run(
                            ["make", "-C", _SRC, "-j4", f"OUT={_OUT}"],
                            capture_output=quiet, timeout=300, check=True)
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)
        except (OSError, ImportError, subprocess.SubprocessError):
            return False
        finally:
            _done = True
        return all(os.path.exists(os.path.join(_OUT, t))
                   for t in _targets())
