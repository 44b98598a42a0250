"""The compile cache is placed from outside: JAX_COMPILATION_CACHE_DIR
when set, else <checkout>/.cache/jax, and one function sets it."""

import pathlib

from sedef_tpu.debug import compilation_cache_dir

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    assert compilation_cache_dir() == str(tmp_path / "xla")


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert pathlib.Path(compilation_cache_dir()) == CHECKOUT / ".cache" / "jax"


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    import jax

    from sedef_tpu.debug import enable_compilation_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_accelerator_is_none_on_cpu_backend():
    from sedef_tpu.device import accelerator

    assert accelerator() is None
