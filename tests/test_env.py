"""Process set-up helpers: the compile-cache rule and the card query."""

import os

import jax

from volumetric_renderer.utils import env


def test_compile_cache_follows_the_environment():
    assert env.compile_cache_dir({env.CACHE_ENV: "/elsewhere"}) == "/elsewhere"


def test_compile_cache_defaults_to_the_checkout():
    path = env.compile_cache_dir({})
    assert path == os.path.join(env.CHECKOUT, ".jax_cache")
    assert os.path.exists(os.path.join(env.CHECKOUT, "chip_smoke.py"))
    with open(os.path.join(env.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_nothing_when_the_variable_is_set():
    before = jax.config.jax_compilation_cache_dir
    assert env.enable_compile_cache({env.CACHE_ENV: "/elsewhere"}) \
        == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_points_jax_at_the_checkout():
    before = jax.config.jax_compilation_cache_dir
    try:
        path = env.enable_compile_cache({})
        assert jax.config.jax_compilation_cache_dir == path
        assert path.startswith(env.CHECKOUT)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_card_query_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert env.gpu_name_and_power_limit() is None
