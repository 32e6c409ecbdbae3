"""Runtime environments: per-task/actor execution environments.

Analog of the reference's runtime_env stack (reference:
python/ray/_private/runtime_env/{plugin.py,working_dir.py,py_modules.py,
pip.py,conda.py} — plugins set up an env on the executing node; code
packages travel as zips through GCS KV).  Plugin registry with:

- env_vars: applied in-process before execution
- working_dir: local path → chdir; non-existent on the worker's node →
  uploaded as a zip through the head KV at submit, extracted per worker
- py_modules: module files/dirs zipped through the head KV, placed on
  sys.path in the worker
- pip: venv-per-env-hash created on the executing node on demand
  (reference: _private/runtime_env/pip.py — theirs builds a virtualenv
  via the dashboard agent and dedicates workers to it).  OFFLINE by
  design: installs run `--no-index` against local wheels/source trees
  (``find_links`` dirs or direct paths), because this TPU-VM image has
  no package egress.  A pooled worker enters the env by activating it
  (VIRTUAL_ENV + PATH + the venv's site-packages on sys.path) with a
  full undo — subprocesses the task spawns resolve `python` to the venv
  interpreter, like a shell `activate`.
- conda / container: setup raises with an explanation (no conda binary /
  container runtime in the image)
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import tempfile
import zipfile
from typing import Any, Dict, List

_MAX_PACKAGE_BYTES = 100 << 20


def _zip_path(path: str) -> bytes:
    """Zip a file or directory tree into bytes (reference analog:
    _private/runtime_env/packaging.py create_package)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            base = os.path.basename(os.path.normpath(path))
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if f.endswith(".pyc") or "__pycache__" in root:
                        continue
                    full = os.path.join(root, f)
                    rel = os.path.join(base, os.path.relpath(full, path))
                    zf.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES}); ship data via the object store instead"
        )
    return data


def _tree_stamp(path: str) -> tuple:
    """Cheap change detector for the upload cache: (path, mtime of the
    newest file, file count)."""
    if os.path.isfile(path):
        st = os.stat(path)
        return (path, st.st_mtime_ns, 1)
    newest, count = 0, 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                m = os.stat(os.path.join(root, f)).st_mtime_ns
            except OSError:
                continue
            newest = max(newest, m)
            count += 1
    return (path, newest, count)


def _upload_package(cw, path: str) -> str:
    # per-driver cache: submitting 1000 tasks with the same working_dir
    # must not zip + ship the tree 1000 times
    cache = getattr(cw, "_runtime_env_pkg_cache", None)
    if cache is None:
        cache = cw._runtime_env_pkg_cache = {}
    stamp = _tree_stamp(path)
    key = cache.get(stamp)
    if key is not None:
        return key
    data = _zip_path(path)
    key = f"runtime_env:{hashlib.sha1(data).hexdigest()}"
    cw.kv_put(key, data, overwrite=False)
    cache[stamp] = key
    return key


def process_runtime_env(cw, renv: Dict[str, Any]) -> Dict[str, Any]:
    """Driver-side: validate + upload local code so the worker (possibly on
    another node) can materialize it.  Returns the wire form."""
    if not renv:
        return {}
    unknown = set(renv) - {
        "env_vars",
        "working_dir",
        "py_modules",
        "pip",
        "conda",
        "container",
        # derived keys: re-processing an already-processed env is a no-op
        "working_dir_key",
        "py_modules_keys",
    }
    if unknown:
        raise ValueError(f"unsupported runtime_env keys: {sorted(unknown)}")
    out = dict(renv)
    wd = renv.get("working_dir")
    if wd and os.path.exists(wd) and "working_dir_key" not in out:
        # upload so remote nodes (no shared FS assumed) get the same tree;
        # the local path is kept as a fast path for same-node workers
        out["working_dir_key"] = _upload_package(cw, wd)
    mods = renv.get("py_modules")
    if mods and "py_modules_keys" not in out:
        keys = []
        for m in mods:
            if not os.path.exists(m):
                raise FileNotFoundError(f"py_modules path not found: {m}")
            keys.append(_upload_package(cw, m))
        out["py_modules_keys"] = keys
    return out


def apply_runtime_env(cw, renv: Dict[str, Any], session_dir: str = ""):
    """Worker-side: materialize the env before executing user code.
    Returns an undo callable — pool workers are REUSED, so the sys.path
    entries this adds must not leak into later tasks (a shipped 'utils'
    package shadowing site-packages for an unrelated task is a silent
    wrong-answer bug).  Reference analog: RuntimeEnvContext.exec_worker,
    context.py:46 — theirs dedicates workers per env; ours undoes."""
    if not renv:
        return lambda: None
    if renv.get("conda") or renv.get("container"):
        raise RuntimeError(
            "conda/container runtime envs need a conda binary / container "
            "runtime this TPU-VM image lacks — use pip (offline, local "
            "wheels) or py_modules instead"
        )
    prev_env: Dict[str, Any] = {}
    prev_cwd = os.getcwd()
    added_paths: List[str] = []
    pre_modules = set(sys.modules)

    def _undo():
        # removing the paths is not enough: modules the task imported from
        # them stay cached in sys.modules and would leak into the reused
        # worker's next task — purge everything that ORIGINATED there
        import importlib

        roots = tuple(added_paths)
        if roots:
            for name, mod in list(sys.modules.items()):
                if name in pre_modules:
                    continue
                origin = getattr(mod, "__file__", None)
                if origin is None:
                    paths = list(getattr(mod, "__path__", []) or [])
                    origin = paths[0] if paths else None
                if origin and origin.startswith(roots):
                    sys.modules.pop(name, None)
        for p in added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        importlib.invalidate_caches()
        for k, old in prev_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        try:
            os.chdir(prev_cwd)
        except OSError:
            pass

    try:
        for k, v in (renv.get("env_vars") or {}).items():
            k = str(k)
            prev_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        stage_root = os.path.join(
            session_dir or tempfile.gettempdir(), "runtime_env_staging"
        )
        if renv.get("pip"):
            env_dir = _ensure_pip_env(renv["pip"], session_dir)
            site = _venv_site_packages(env_dir)
            if site not in sys.path:
                sys.path.insert(0, site)
                added_paths.append(site)
            # activate for subprocesses the task spawns
            for k, v in (
                ("VIRTUAL_ENV", env_dir),
                ("PATH", os.path.join(env_dir, "bin") + os.pathsep + os.environ.get("PATH", "")),
            ):
                prev_env.setdefault(k, os.environ.get(k))
                os.environ[k] = v
        for key in renv.get("py_modules_keys") or []:
            target = _materialize(cw, key, stage_root)
            if target not in sys.path:
                sys.path.insert(0, target)
                added_paths.append(target)
        wd = renv.get("working_dir")
        if wd:
            if renv.get("working_dir_key"):
                # ALWAYS use the uploaded snapshot: the live local dir may
                # have mutated since submit (or hold a stale copy on another
                # node) — every task of the job must see the same tree
                wd = _materialize(cw, renv["working_dir_key"], stage_root, flatten=True)
            os.chdir(wd)
            if wd not in sys.path:
                sys.path.insert(0, wd)
                added_paths.append(wd)
    except BaseException:
        # a half-applied env must not leak into the reused worker's next
        # task — exactly the bug the undo exists for
        _undo()
        raise

    return _undo


def _normalize_pip_spec(pip: Any) -> Dict[str, Any]:
    """Accept ``pip=[...]`` (package list) or ``pip={"packages": [...],
    "find_links": [...], "no_build_isolation": bool}`` (reference wire
    shape: runtime_env/pip.py parse)."""
    if isinstance(pip, (list, tuple)):
        spec = {"packages": [str(p) for p in pip]}
    elif isinstance(pip, dict):
        spec = {
            "packages": [str(p) for p in pip.get("packages", [])],
            "find_links": [str(p) for p in pip.get("find_links", [])],
            "no_build_isolation": bool(pip.get("no_build_isolation", False)),
        }
    else:
        raise ValueError(f"pip runtime_env must be a list or dict, got {type(pip)}")
    spec.setdefault("find_links", [])
    spec.setdefault("no_build_isolation", False)
    if not spec["packages"]:
        raise ValueError("pip runtime_env has no packages")
    return spec


def pip_env_hash(pip: Any) -> str:
    import json

    spec = _normalize_pip_spec(pip)
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _venv_site_packages(env_dir: str) -> str:
    import glob

    hits = glob.glob(os.path.join(env_dir, "lib", "python*", "site-packages"))
    if not hits:
        raise RuntimeError(f"venv at {env_dir} has no site-packages")
    return hits[0]


def _ensure_pip_env(pip: Any, session_dir: str = "") -> str:
    """Create (once per env hash, per node) a venv with the requested
    packages installed OFFLINE (`pip install --no-index`): packages must
    be local wheel/source paths or resolvable from ``find_links`` dirs /
    $RAY_TPU_PIP_FIND_LINKS — this image has no package egress.  Built
    in place under a mkdir lock; concurrent workers poll for the done
    marker (reference analog: _private/runtime_env/pip.py PipProcessor,
    one builder per env via the agent)."""
    import shutil
    import subprocess
    import time

    spec = _normalize_pip_spec(pip)
    key = pip_env_hash(pip)
    root = os.path.join(session_dir or tempfile.gettempdir(), "runtime_env_venvs")
    env_dir = os.path.join(root, key)
    marker = env_dir + ".done"
    if os.path.exists(marker):
        return env_dir
    os.makedirs(root, exist_ok=True)
    lock = env_dir + ".lock"
    try:
        os.mkdir(lock)
    except FileExistsError:
        # another worker is building: wait for its marker.  A lock older
        # than the build's worst case (venv 300s cap + pip 600s cap, plus
        # headroom) is STALE (builder SIGKILLed mid-build skips the
        # finally) — break it and take over rather than wedging every
        # future task with this env forever.
        deadline = time.time() + 1200
        while time.time() < deadline:
            if os.path.exists(marker):
                return env_dir
            try:
                age = time.time() - os.stat(lock).st_mtime
            except OSError:
                return _ensure_pip_env(pip, session_dir)  # builder finished/died
            if age > 1200:
                try:
                    os.rmdir(lock)
                except OSError:
                    pass
                return _ensure_pip_env(pip, session_dir)
            time.sleep(0.25)
        raise TimeoutError(f"pip env {key} build timed out waiting on {lock}")
    try:
        if os.path.exists(marker):
            return env_dir
        shutil.rmtree(env_dir, ignore_errors=True)
        # --system-site-packages: the image's baked deps (jax, numpy, ...)
        # stay importable; the venv only ADDS the requested packages
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", env_dir],
            check=True,
            capture_output=True,
            timeout=300,
        )
        vpy = os.path.join(env_dir, "bin", "python")
        cmd = [vpy, "-m", "pip", "install", "--no-index", "--quiet"]
        links = list(spec["find_links"])
        env_links = os.environ.get("RAY_TPU_PIP_FIND_LINKS", "")
        links += [p for p in env_links.split(os.pathsep) if p]
        for fl in links:
            cmd += ["--find-links", fl]
        if spec["no_build_isolation"]:
            cmd += ["--no-build-isolation"]
        cmd += spec["packages"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            shutil.rmtree(env_dir, ignore_errors=True)
            raise RuntimeError(
                f"pip runtime_env install failed (offline --no-index; packages "
                f"must be local paths or in find_links):\n{proc.stderr[-2000:]}"
            )
        with open(marker, "w") as f:
            f.write("ok")
        return env_dir
    finally:
        try:
            os.rmdir(lock)
        except OSError:
            pass


def _materialize(cw, key: str, stage_root: str, flatten: bool = False) -> str:
    """Download + extract a KV package once per key (content-addressed).
    Concurrent workers race here: extract into a private temp dir and
    os.rename atomically, so nobody ever imports a half-written file."""
    target = os.path.join(stage_root, key.split(":", 1)[1])
    marker = target + ".done"
    if not os.path.exists(marker):
        data = cw.kv_get(key)
        if data is None:
            raise RuntimeError(f"runtime_env package {key} missing from KV")
        os.makedirs(stage_root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".staging-", dir=stage_root)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, target)
        except OSError:
            # another worker won the rename; use its copy
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
        with open(marker, "w") as f:
            f.write("ok")
    if flatten:
        # a working_dir zip holds one top-level dir: chdir inside it
        entries = [e for e in os.listdir(target) if not e.endswith(".done")]
        if len(entries) == 1 and os.path.isdir(os.path.join(target, entries[0])):
            return os.path.join(target, entries[0])
    return target
