"""Runtime environments: per-task/actor working_dir, py_modules, env_vars.

Counterpart of the reference's runtime-env system
(reference: python/ray/_private/runtime_env/ — working_dir.py py_modules
packaging into GCS-hosted zip packages, plugin API plugin.py; the
runtime-env agent applies them before user code runs). Scoped to the
plugins that work with zero egress:

  env_vars     — applied around task execution (worker.py, pre-existing)
  working_dir  — a local directory zipped at submit time, content-hash
                 stored in the cluster KV, extracted + chdir'd worker-side
  py_modules   — same packaging, each entry prepended to sys.path

  pip          — per-env package directory (reference:
                 _private/runtime_env/pip.py). Zero-egress posture: pip
                 runs with --no-index by DEFAULT, resolving from local
                 wheel dirs (``find_links``) or explicit index config —
                 installs land in a content-hashed --target directory
                 built once per node and path-scoped per task. Process
                 isolation is path-level (this runtime shares one
                 interpreter per worker), vs the reference's per-process
                 virtualenv; clashing binary deps should still be
                 pre-baked into the image.

container/image_uri envs are rejected with a clear error (they need
interpreter environments — pre-bake instead, the reference's
recommended production posture as well).
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import sys
import zipfile

_EXCLUDE_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}
MAX_PACKAGE_BYTES = 100 * 1024 * 1024  # reference default cap is 100 MiB


def _zip_dir(path: str, *, under_basename: bool = False) -> bytes:
    """under_basename=True archives a directory UNDER its own name (the
    py_modules contract: passing /path/to/my_module must make
    `import my_module` work from the extract root — reference semantics,
    _private/runtime_env/py_modules.py)."""
    buf = io.BytesIO()
    base = os.path.abspath(path)
    prefix = os.path.basename(base) if under_basename else ""
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(base):
            zf.write(base, os.path.basename(base))
        else:
            for root, dirs, files in os.walk(base):
                dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
                for f in sorted(files):
                    if f.endswith(".pyc"):
                        continue
                    full = os.path.join(root, f)
                    arc = os.path.join(prefix, os.path.relpath(full, base))
                    zf.write(full, arc)
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(blob)} bytes "
            f"(cap {MAX_PACKAGE_BYTES}); exclude large data directories"
        )
    return blob


def pack(runtime_env: dict | None, rt) -> dict | None:
    """Driver-side: upload local dirs into the cluster KV, rewrite the env
    to URIs (reference: working_dir.py upload_package_if_needed)."""
    if not runtime_env:
        return runtime_env
    for bad in ("container", "image_uri"):
        if runtime_env.get(bad):
            raise ValueError(
                f"runtime_env[{bad!r}] needs a container runtime on every "
                f"node (reference: _private/runtime_env/image_uri.py); "
                f"this deployment runs workers as host processes"
            )
    env = dict(runtime_env)

    def upload(path: str, *, under_basename: bool = False) -> str:
        blob = _zip_dir(path, under_basename=under_basename)
        uri = "pkg:" + hashlib.sha256(blob).hexdigest()[:32]
        rt.kv_put(uri, blob, ns="__runtime_env__", overwrite=False)
        return uri

    if env.get("pip"):
        spec = normalize_pip_spec(env["pip"])
        fl = spec.get("find_links")
        if fl and not fl.startswith(("pkg:", "http://", "https://",
                                     "file://")):
            if not os.path.isdir(fl):
                raise ValueError(
                    f"runtime_env pip find_links {fl!r} is not a "
                    f"directory on the driver (bad specs fail at "
                    f"submit, not on a worker)")
            # Ship the wheel dir through the cluster KV so workers on
            # EVERY node can resolve from it, not just the driver host.
            blob = _zip_dir(fl)
            uri = "pkg:" + hashlib.sha256(blob).hexdigest()[:32]
            rt.kv_put(uri, blob, ns="__runtime_env__", overwrite=False)
            spec["find_links"] = uri
        env["pip"] = spec
    if env.get("uv"):
        spec = normalize_uv_spec(env["uv"])
        fl = spec.get("find_links")
        if fl and not fl.startswith(("pkg:", "http://", "https://",
                                     "file://")):
            if not os.path.isdir(fl):
                raise ValueError(
                    f"runtime_env uv find_links {fl!r} is not a "
                    f"directory on the driver")
            blob = _zip_dir(fl)
            uri = "pkg:" + hashlib.sha256(blob).hexdigest()[:32]
            rt.kv_put(uri, blob, ns="__runtime_env__", overwrite=False)
            spec["find_links"] = uri
        env["uv"] = spec
    if env.get("conda"):
        spec = normalize_conda_spec(env["conda"])
        fl = spec.get("find_links")
        if fl and not fl.startswith(("pkg:", "http://", "https://",
                                     "file://")):
            if not os.path.isdir(fl):
                raise ValueError(
                    f"runtime_env conda find_links {fl!r} is not a "
                    f"directory on the driver")
            blob = _zip_dir(fl)
            uri = "pkg:" + hashlib.sha256(blob).hexdigest()[:32]
            rt.kv_put(uri, blob, ns="__runtime_env__", overwrite=False)
            spec["find_links"] = uri
        env["conda"] = spec
    if env.get("working_dir") and not str(env["working_dir"]).startswith("pkg:"):
        env["working_dir"] = upload(env["working_dir"])
    if env.get("py_modules"):
        # A module DIRECTORY is archived under its basename so the extract
        # root makes `import <basename>` work (single files land at the
        # root already).
        env["py_modules"] = [
            m if str(m).startswith("pkg:") else upload(m, under_basename=os.path.isdir(m))
            for m in env["py_modules"]
        ]
    return env


def normalize_pip_spec(spec) -> dict:
    """Canonical pip spec (reference: pip.py accepts a list of
    requirements or {"packages": [...], ...}). Driver-side validation so
    bad specs fail at submit, not on a worker."""
    if isinstance(spec, (list, tuple)):
        spec = {"packages": list(spec)}
    if not isinstance(spec, dict) or not spec.get("packages"):
        raise ValueError(
            "runtime_env['pip'] must be a list of requirements or "
            "{'packages': [...], 'find_links': dir, 'index_url': url}")
    out = {"packages": [str(p) for p in spec["packages"]]}
    for key in ("find_links", "index_url"):
        if spec.get(key):
            out[key] = str(spec[key])
    return out


def normalize_uv_spec(spec) -> dict:
    """uv env spec (reference: _private/runtime_env/uv.py — accepts a
    requirements list or {"packages": [...], "uv_version", "uv_check",
    ...}). The version/check knobs are image-management concerns and
    are ignored here (the image ships one uv); packages resolve
    OFFLINE by default like the pip path."""
    if isinstance(spec, (list, tuple)):
        spec = {"packages": list(spec)}
    if not isinstance(spec, dict) or not spec.get("packages"):
        raise ValueError(
            "runtime_env['uv'] must be a list of requirements or "
            "{'packages': [...], 'find_links': dir, 'index_url': url}")
    out = {"packages": [str(p) for p in spec["packages"]]}
    for key in ("find_links", "index_url"):
        if spec.get(key):
            out[key] = str(spec[key])
    return out


def normalize_conda_spec(spec) -> dict:
    """Conda-lite (reference: _private/runtime_env/conda.py — the
    reference builds a full conda env; here a venv seeded from the
    worker's interpreter, with the pip-package subset of the spec
    resolved OFFLINE via find_links/index_url). Accepted forms:
      - ["pkg==1.0", ...]                         (pip packages)
      - {"packages": [...], "find_links"/"index_url": ...}
      - conda-yaml style {"dependencies": ["python", {"pip": [...]}]}
        — non-pip conda dependencies are rejected (no conda binary in
        the zero-egress posture; python itself is allowed and ignored).
    """
    if isinstance(spec, (list, tuple)):
        return {"packages": [str(p) for p in spec]}
    if not isinstance(spec, dict):
        raise ValueError("runtime_env['conda'] must be a list or dict")
    if "dependencies" in spec:
        pip_pkgs: list[str] = []
        for dep in spec["dependencies"]:
            if isinstance(dep, dict) and "pip" in dep:
                pip_pkgs.extend(str(p) for p in dep["pip"])
            elif isinstance(dep, str) and (
                    dep == "pip"
                    or re.fullmatch(r"python\s*([<>=!~].*)?", dep)):
                # The interpreter/pip themselves: provided by the venv.
                # ONLY an exact "python" (optionally version-pinned) —
                # a prefix match would silently swallow real packages
                # like python-dateutil.
                continue
            else:
                raise ValueError(
                    f"conda dependency {dep!r} needs the conda binary; "
                    f"this conda-lite backend resolves only pip "
                    f"packages (list them under a {{'pip': [...]}} "
                    f"entry) from local wheels")
        spec = {"packages": pip_pkgs, **{k: spec[k] for k in
                                         ("find_links", "index_url")
                                         if spec.get(k)}}
    if not spec.get("packages"):
        raise ValueError(
            "runtime_env['conda'] resolved to no pip packages; use "
            "{'packages': [...]} or conda-yaml {'dependencies': "
            "[{'pip': [...]}]}")
    out = {"packages": [str(p) for p in spec["packages"]]}
    for key in ("find_links", "index_url"):
        if spec.get(key):
            out[key] = str(spec[key])
    return out


def _venv_env_dir(spec: dict, cache_dir: str,
                  find_links_path: "str | None" = None) -> str:
    """Build a content-hashed venv (--system-site-packages so the base
    image's jax/numpy remain importable) and pip-install the spec into
    it, once per node. Returns the venv root. Same lock/marker recipe as
    _pip_env_dir; the venv's own pip runs offline by default."""
    import shutil
    import subprocess

    key = hashlib.sha256(
        ("venv:" + repr(sorted(spec.items()))).encode()).hexdigest()[:24]
    target = os.path.join(cache_dir, "venvs", key)
    marker = target + ".ok"
    if os.path.exists(marker):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    import fcntl

    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return target
            tmp = target + f".tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            proc = subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 "--without-pip", tmp],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"venv creation failed: {proc.stderr[-1000:]}")
            # Install with the PARENT interpreter's pip targeting the
            # venv's site-packages (--without-pip venvs are cheap and
            # ensurepip may be unavailable offline).
            site = _venv_site(tmp)
            cmd = [sys.executable, "-m", "pip", "install", "--quiet",
                   "--no-cache-dir", "--target", site]
            if spec.get("index_url"):
                cmd += ["--index-url", spec["index_url"]]
            else:
                cmd += ["--no-index"]
            if find_links_path or spec.get("find_links"):
                cmd += ["--find-links",
                        find_links_path or spec["find_links"]]
            cmd += spec["packages"]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"runtime_env venv install failed "
                    f"(rc={proc.returncode}): {proc.stderr[-2000:]}\n"
                    f"(zero-egress default is --no-index: provide "
                    f"'find_links' with local wheels, or an explicit "
                    f"'index_url')")
            shutil.rmtree(target, ignore_errors=True)
            os.rename(tmp, target)
            with open(marker, "w") as f:
                f.write("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _venv_site(root: str) -> str:
    ver = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    return os.path.join(root, "lib", ver, "site-packages")


def _uv_env_dir(spec: dict, cache_dir: str,
                find_links_path: "str | None" = None) -> str:
    """Build a content-hashed venv with the uv toolchain (reference:
    _private/runtime_env/uv.py — uv venv + uv pip install per env
    hash). Same lock/marker/atomic-rename recipe as _venv_env_dir;
    offline by default (--no-index + find_links). Falls back to the
    python -m venv + pip recipe when no uv binary is on PATH."""
    import shutil
    import subprocess

    uv = shutil.which("uv")
    if uv is None:
        return _venv_env_dir(spec, cache_dir,
                             find_links_path=find_links_path)
    key = hashlib.sha256(
        ("uv:" + repr(sorted(spec.items()))).encode()).hexdigest()[:24]
    target = os.path.join(cache_dir, "uv_envs", key)
    marker = target + ".ok"
    if os.path.exists(marker):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    import fcntl

    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return target
            tmp = target + f".tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            proc = subprocess.run(
                [uv, "venv", "--system-site-packages",
                 "--python", sys.executable, tmp],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"uv venv creation failed: {proc.stderr[-1000:]}")
            cmd = [uv, "pip", "install",
                   "--python", os.path.join(tmp, "bin", "python")]
            if spec.get("index_url"):
                cmd += ["--index-url", spec["index_url"]]
            else:
                cmd += ["--no-index"]
            if find_links_path or spec.get("find_links"):
                cmd += ["--find-links",
                        find_links_path or spec["find_links"]]
            cmd += spec["packages"]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"runtime_env uv install failed "
                    f"(rc={proc.returncode}): {proc.stderr[-2000:]}\n"
                    f"(zero-egress default is --no-index: provide "
                    f"'find_links' with local wheels, or an explicit "
                    f"'index_url')")
            shutil.rmtree(target, ignore_errors=True)
            os.rename(tmp, target)
            with open(marker, "w") as f:
                f.write("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _pip_env_dir(spec: dict, cache_dir: str,
                 find_links_path: "str | None" = None) -> str:
    """Install the spec's packages into a content-hashed --target dir,
    once per node (reference: pip.py building one virtualenv per env
    hash; here a path-scoped package dir — same caching contract).
    Zero-egress default: --no-index unless the spec names an index, so
    resolution comes from local wheel dirs (find_links)."""
    import subprocess

    key = hashlib.sha256(repr(sorted(spec.items())).encode()).hexdigest()[:24]
    target = os.path.join(cache_dir, "pip_envs", key)
    marker = target + ".ok"
    if os.path.exists(marker):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    lock_path = target + ".lock"
    # One installer per node: concurrent workers serialize on the lock
    # file; losers find the marker and return.
    import fcntl

    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return target
            # Install into a scratch dir and atomically rename (same
            # recipe as _materialize): a worker killed mid-install must
            # not leave a partial tree that a retrying pip would keep
            # (pip without --upgrade refuses to replace existing package
            # dirs, rc 0) and the marker would then cement.
            import shutil

            tmp = target + f".tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            cmd = [sys.executable, "-m", "pip", "install", "--quiet",
                   "--no-cache-dir", "--target", tmp]
            if spec.get("index_url"):
                cmd += ["--index-url", spec["index_url"]]
            else:
                cmd += ["--no-index"]
            if find_links_path or spec.get("find_links"):
                cmd += ["--find-links",
                        find_links_path or spec["find_links"]]
            cmd += spec["packages"]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"runtime_env pip install failed "
                    f"(rc={proc.returncode}): {proc.stderr[-2000:]}\n"
                    f"(zero-egress default is --no-index: provide "
                    f"'find_links' with local wheels, or an explicit "
                    f"'index_url')")
            shutil.rmtree(target, ignore_errors=True)
            os.rename(tmp, target)
            with open(marker, "w") as f:
                f.write("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


class AppliedEnv:
    """Worker-side application with exact undo (normal tasks run many
    different envs in one process; actors apply once for life)."""

    def __init__(self):
        self._saved_cwd: str | None = None
        self._added_paths: list[str] = []
        self._saved_env: dict[str, "str | None"] = {}

    def apply(self, runtime_env: dict | None, rt, cache_dir: str) -> None:
        if not runtime_env:
            return
        wd_uri = runtime_env.get("working_dir")
        if wd_uri:
            target = _materialize(wd_uri, rt, cache_dir)
            self._saved_cwd = os.getcwd()
            os.chdir(target)
            sys.path.insert(0, target)
            self._added_paths.append(target)
        for uri in runtime_env.get("py_modules") or []:
            target = _materialize(uri, rt, cache_dir)
            sys.path.insert(0, target)
            self._added_paths.append(target)
        pip_spec = runtime_env.get("pip")
        if pip_spec:
            spec = normalize_pip_spec(pip_spec)
            fl = spec.get("find_links")
            if fl and fl.startswith("pkg:"):
                # KV-hosted wheel dir: extract locally, install from it.
                # The env-dir hash stays keyed on the URI (stable across
                # nodes); only the pip command sees the local path.
                local = _materialize(fl, rt, cache_dir)
                target = _pip_env_dir(spec, cache_dir, find_links_path=local)
            else:
                target = _pip_env_dir(spec, cache_dir)
            sys.path.insert(0, target)
            self._added_paths.append(target)
        conda_spec = runtime_env.get("conda")
        if conda_spec:
            spec = normalize_conda_spec(conda_spec)
            fl = spec.get("find_links")
            if fl and fl.startswith("pkg:"):
                local = _materialize(fl, rt, cache_dir)
                root = _venv_env_dir(spec, cache_dir,
                                     find_links_path=local)
            else:
                root = _venv_env_dir(spec, cache_dir)
            self._enter_venv(root)
        uv_spec = runtime_env.get("uv")
        if uv_spec:
            spec = normalize_uv_spec(uv_spec)
            fl = spec.get("find_links")
            if fl and fl.startswith("pkg:"):
                local = _materialize(fl, rt, cache_dir)
                root = _uv_env_dir(spec, cache_dir,
                                   find_links_path=local)
            else:
                root = _uv_env_dir(spec, cache_dir)
            self._enter_venv(root)

    def _enter_venv(self, root: str) -> None:
        site = _venv_site(root)
        sys.path.insert(0, site)
        self._added_paths.append(site)
        # Child processes the task spawns see the venv too.
        for k, v in (("VIRTUAL_ENV", root),
                     ("PATH", os.path.join(root, "bin") + os.pathsep
                      + os.environ.get("PATH", ""))):
            self._saved_env.setdefault(k, os.environ.get(k))
            os.environ[k] = v

    def undo(self) -> None:
        # Path scoping is exact; MODULES a task imported stay cached in
        # sys.modules (one interpreter per worker — the reference gets
        # stricter isolation from per-process virtualenvs). Conflicting
        # package VERSIONS across envs in one worker should use
        # dedicated actors.
        if self._saved_cwd is not None:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass
            self._saved_cwd = None
        for p in self._added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        self._added_paths = []
        for k, v in self._saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._saved_env = {}


def _materialize(uri: str, rt, cache_dir: str) -> str:
    """Extract a KV-hosted package into the content-addressed cache
    (idempotent across tasks/workers on this host)."""
    target = os.path.join(cache_dir, uri.replace(":", "_"))
    marker = target + ".ok"
    if os.path.exists(marker):
        return target
    blob = rt.kv_get(uri, ns="__runtime_env__")
    if blob is None:
        raise RuntimeError(f"runtime_env package {uri} not found in cluster KV")
    tmp = target + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        # Another worker won the race; its copy is identical (same hash).
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    with open(marker, "w") as f:
        f.write("ok")
    return target
