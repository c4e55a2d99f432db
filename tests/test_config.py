"""Env-var flag system (config.py) — the tfigrender_env_override.nim analog:
every runtime toggle parses its documented spellings, unknown values fall
back to defaults, and the renderer constructor honors the backend override.
Reference: figrender.nim:103-176, utils/glutils.nim:12-40.
"""

import pytest

from figdraw_tpu import config


@pytest.mark.parametrize("value,expect", [
    ("1", True), ("true", True), ("YES", True), ("on", True),
    ("0", False), ("false", False), ("", False), ("banana", False),
])
def test_truthy_spellings(monkeypatch, value, expect):
    monkeypatch.setenv("FIGDRAW_TEXT_SUBPIXEL_POSITIONING", value)
    assert config.runtime_text_subpixel_positioning_requested() is expect


def test_lcd_filtering_primary_name_wins_over_alt(monkeypatch):
    # the short alt spelling counts only when the primary is unset
    monkeypatch.delenv("FIGDRAW_TEXT_LCD_FILTERING", raising=False)
    monkeypatch.setenv("FIGDRAW_TEXT_LCD_FILTER", "1")
    assert config.runtime_text_lcd_filtering_requested()
    monkeypatch.setenv("FIGDRAW_TEXT_LCD_FILTERING", "0")
    assert not config.runtime_text_lcd_filtering_requested()


@pytest.mark.parametrize("backend,expect", [
    ("pallas", True), ("xla", False), ("ref", False), ("REFERENCE", False),
    ("", None), ("vulkan", None),
])
def test_backend_override_values(monkeypatch, backend, expect):
    monkeypatch.delenv("FIGDRAW_FORCE_XLA", raising=False)
    monkeypatch.setenv("FIGDRAW_BACKEND", backend)
    assert config.runtime_backend_override() is expect


def test_force_xla_flag(monkeypatch):
    monkeypatch.setenv("FIGDRAW_BACKEND", "")
    monkeypatch.setenv("FIGDRAW_FORCE_XLA", "1")
    assert config.runtime_backend_override() is False
    assert config.runtime_force_xla_requested()


def test_renderer_honors_backend_override(monkeypatch):
    """Env override applies when the constructor leaves use_pallas unset;
    an explicit argument wins (figrender.nim's constructor precedence)."""
    from figdraw_tpu.renderer import FigRenderer

    monkeypatch.setenv("FIGDRAW_BACKEND", "xla")
    assert FigRenderer(atlas_size=64).use_pallas is False
    monkeypatch.setenv("FIGDRAW_BACKEND", "pallas")
    assert FigRenderer(atlas_size=64).use_pallas is True
    assert FigRenderer(atlas_size=64, use_pallas=False).use_pallas is False


def test_batch_chunk_parses_and_clamps(monkeypatch):
    monkeypatch.setenv("FIGDRAW_BATCH_CHUNK", "4")
    assert config.batch_chunk() == 4
    monkeypatch.setenv("FIGDRAW_BATCH_CHUNK", "0")
    assert config.batch_chunk() == 1
    monkeypatch.setenv("FIGDRAW_BATCH_CHUNK", "not-a-number")
    assert config.batch_chunk() == 8


@pytest.fixture
def _restore_cache_config():
    import jax

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_lands_exactly_in_env_dir(monkeypatch, tmp_path,
                                                _restore_cache_config):
    import jax

    from figdraw_tpu.utils import jaxcache

    target = tmp_path / "given"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    jaxcache.enable_compilation_cache(platform="gpu")
    # used as given: no backend subdirectory, no other directory
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir() and not any(target.iterdir())


def test_compile_cache_defaults_to_one_dir_in_the_checkout(
        monkeypatch, _restore_cache_config):
    import os

    import jax

    from figdraw_tpu.utils import jaxcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    before = jax.config.jax_compilation_cache_dir
    jaxcache.enable_compilation_cache(platform="cpu")  # GPU only
    assert jax.config.jax_compilation_cache_dir == before
