"""An installed port keeps its native lane: the wheel carries
ray_tpu_torch/src/ (the Makefile and the C/C++ sources of the object
store, the spec codec, the event loop, the scheduler and the channel
ring, which the port builds on first import), and the build directory
falls back to a per-user cache where the one beside the package cannot
be written (a read-only site-packages). It also carries the dashboard's
web UI (ray_tpu_torch/dashboard_ui.html)."""

import glob
import importlib.util
import os
import shutil
import subprocess
import sys
import zipfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    os.path.relpath(p, ROOT) for pattern in ("Makefile", "*/*.c", "*/*.cc", "*/*.h")
    for p in glob.glob(os.path.join(ROOT, "ray_tpu_torch", "src", pattern)))


def _committed_tree(dest):
    """The files a commit of this checkout holds (tracked and untracked
    ones that .gitignore does not list), copied to ``dest``."""
    listed = subprocess.run(["git", "ls-files", "-co", "--exclude-standard", "-z"],
                            cwd=ROOT, capture_output=True, timeout=60)
    if listed.returncode != 0:  # not a git checkout: the packaging inputs
        names = ["pyproject.toml", "setup.py", "MANIFEST.in"]
        for pkg in ("ray_tpu", "ray_tpu_torch"):
            for d, _, files in os.walk(os.path.join(ROOT, pkg)):
                names += [os.path.relpath(os.path.join(d, f), ROOT) for f in files
                          if "__pycache__" not in d]
    else:
        names = [n for n in listed.stdout.decode().split("\0") if n]
    for name in names:
        src = os.path.join(ROOT, name)
        if os.path.isfile(src):
            os.makedirs(os.path.join(dest, os.path.dirname(name)), exist_ok=True)
            shutil.copy2(src, os.path.join(dest, name))


def test_wheel_carries_the_native_sources(tmp_path):
    assert "ray_tpu_torch/src/Makefile" in PORT_SOURCES and len(PORT_SOURCES) >= 6
    tree, out = tmp_path / "tree", tmp_path / "wheel"
    _committed_tree(str(tree))
    built = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-deps",
         "--no-cache-dir", "-q", "-w", str(out), str(tree)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PIP_NO_INPUT="1", PIP_DISABLE_PIP_VERSION_CHECK="1"))
    assert built.returncode == 0, built.stderr[-4000:]
    (wheel,) = glob.glob(str(out / "*.whl"))
    names = set(zipfile.ZipFile(wheel).namelist())
    assert set(PORT_SOURCES) <= names, sorted(set(PORT_SOURCES) - names)
    assert {"ray_tpu_torch/csrc/flash_fwd.cu", "ray_tpu_torch/csrc/hopper.cuh"} <= names
    # the dashboard serves its web UI from the installed package
    assert "ray_tpu_torch/dashboard_ui.html" in names


def _install_native_build(pkg_dir):
    """native_build.py copied where an installed package would hold it."""
    path = os.path.join(pkg_dir, "_private", "native_build.py")
    os.makedirs(os.path.dirname(path))
    shutil.copy2(os.path.join(ROOT, "ray_tpu_torch", "_private", "native_build.py"), path)
    return path


def _load(path, monkeypatch, cache):
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    spec = importlib.util.spec_from_file_location("native_build_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_dir_falls_back_to_a_user_cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    # A writable site: the build goes beside the package, as in a checkout.
    site = tmp_path / "site"
    nb = _load(_install_native_build(str(site / "ray_tpu_torch")), monkeypatch, cache)
    assert nb._OUT == str(site / "build" / "ray_tpu_torch" / "native")
    # A read-only site (and, since root writes anywhere, a file where
    # build/ would go): the per-user cache, which can be written.
    ro = tmp_path / "ro_site"
    path = _install_native_build(str(ro / "ray_tpu_torch"))
    (ro / "build").write_text("not a directory")
    os.chmod(ro, 0o555)
    try:
        nb = _load(path, monkeypatch, cache)
    finally:
        os.chmod(ro, 0o755)
    assert nb._OUT == str(cache / "ray_tpu_torch" / "native")
    os.makedirs(nb._OUT)
    with open(os.path.join(nb._OUT, "probe"), "w") as f:
        f.write("ok")
    # The kernels' build directory follows the same rule.
    from ray_tpu_torch._private import native_build
    from ray_tpu_torch.ops import _kernels

    assert str(_kernels.BUILD_DIR) == native_build.build_dir()
