"""ops/route.py (platform -> implementation) and the compile-cache helper."""

import importlib

import pytest

from jaxjpeg.ops import route


@pytest.mark.parametrize(
    "platform,interpret,want",
    [
        ("gpu", None, route.KERNEL),
        ("cpu", None, route.PLAIN),
        ("cpu", True, route.INTERPRET),
        ("gpu", True, route.INTERPRET),
        ("cpu", False, route.PLAIN),
    ],
)
def test_route_by_platform(platform, interpret, want):
    assert route.route(interpret, platform=platform) == want


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal"])
def test_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no device route"):
        route.route(platform=platform)


def test_route_default_platform_is_cpu_here():
    assert route.route() == route.PLAIN


def test_forced_route_is_scoped_per_op():
    with route.forced(route.KERNEL, op="index_scan"):
        assert route.route(platform="cpu", op="index_scan") == route.KERNEL
        assert route.route(platform="cpu", op="entropy_decode") == route.PLAIN
        with route.forced(route.PLAIN):
            assert route.route(platform="gpu", op="entropy_decode") == route.PLAIN
            assert route.route(platform="gpu", op="index_scan") == route.KERNEL
    assert route.route(platform="gpu", op="index_scan") == route.KERNEL
    assert route.route(platform="cpu", op="index_scan") == route.PLAIN
    with pytest.raises(ValueError):
        with route.forced(route.INTERPRET):
            pass


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax

    from jaxjpeg.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_dir(monkeypatch):
    import jax

    from jaxjpeg.utils import cache

    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cache.enable_compile_cache()
        assert got == str(cache.DEFAULT_DIR)
        assert cache.DEFAULT_DIR.name == ".jax_cache"
        assert (cache.DEFAULT_DIR.parent / "jaxjpeg").is_dir()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_kernel_module_imports_tpu_pallas():
    for name in ("entropy_device", "specsync_device", "pack_device"):
        mod = importlib.import_module(f"jaxjpeg.ops.{name}")
        src = open(mod.__file__).read()
        assert "pallas.tpu" not in src and "default_backend" not in src
