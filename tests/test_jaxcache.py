"""utils/jaxcache.enable: JAX_COMPILATION_CACHE_DIR, when set, stays in
force; otherwise the cache sits at a fixed, git-ignored path in the
checkout."""

import pathlib

import jax

from varlociraptor_tpu.utils import jaxcache

REPO = pathlib.Path(__file__).resolve().parent.parent


def _updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_honours_jax_compilation_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _updates(monkeypatch)
    jaxcache.enable()
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5


def test_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _updates(monkeypatch)
    jaxcache.enable()
    d = pathlib.Path(calls["jax_compilation_cache_dir"])
    assert d == REPO / ".jax_cache" and d.is_dir()
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored
