"""Persistent compilation cache wiring (utils/compile_cache)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_RUN = """
import jax
from ofdm_ls_mrc_tpu.utils import compile_cache
d = compile_cache.enable()
print("dir:", d, "config:", jax.config.jax_compilation_cache_dir)
# Small test programs compile in < the 0.5 s production threshold; lower it
# so this smoke populates the cache.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
import jax.numpy as jnp
import numpy as np
x = jnp.asarray(np.random.default_rng(0).standard_normal((64, 128),
                dtype=np.float32))
jax.jit(lambda v: (v @ v.T).sum())(x).block_until_ready()
print("entries:", sum(len(fs) for _, _, fs in __import__("os").walk(d)))
"""


def _run(env_dir):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _RUN], capture_output=True,
                       text=True, env=env, timeout=120, cwd="/")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    return lines[0].split()[1], lines[0].split()[3], int(lines[-1].split()[-1])


def test_cache_persists_across_processes(tmp_path):
    """First process populates the cache dir; a second process starts with
    the entries already on disk (the cold-start cut for the apps)."""
    d = str(tmp_path / "xla")
    _, _, n1 = _run(d)
    assert n1 > 0, "first process wrote no cache entries"
    _, _, n2 = _run(d)
    assert n2 >= n1  # second process reuses (and may add) entries


def test_env_dir_wins(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory is used, and the code
    sets no other."""
    d = str(tmp_path / "from_env")
    used, config, _ = _run(d)
    assert used == d and config == d


@pytest.mark.parametrize("env_value", [None, ""])
def test_default_dir_is_fixed_inside_checkout(monkeypatch, env_value):
    """Unset (or empty): one fixed path inside the checkout, whatever the
    working directory or HOME, and git-ignored."""
    from ofdm_ls_mrc_tpu.utils import compile_cache

    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    monkeypatch.setenv("HOME", "/nonexistent-home")
    monkeypatch.chdir("/")
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_default_dir_used_by_a_process():
    used, config, n = _run(None)
    assert used == config == os.path.join(REPO, ".jax_cache")
