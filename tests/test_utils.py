"""Profiling / logging utilities (SURVEY.md §5 aux subsystems)."""
import json
import logging

import numpy as np


def test_step_occupancy_monotone(lambert_scene):
    """Occupancy starts at 1 and never exceeds 1; decays as paths die."""
    from pbrlab_tpu.utils.profiling import step_occupancy

    fracs = np.asarray(step_occupancy(lambert_scene, 16, 16, max_steps=6))
    assert fracs.shape == (6,)
    assert fracs[0] == 1.0
    assert (fracs <= 1.0).all() and (fracs >= 0.0).all()
    # russian roulette + misses must kill some lanes within a few bounces
    assert fracs[-1] < 1.0


def test_measure_occupancy_positive():
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.utils.profiling import measure_occupancy

    scene_np, _ = build_demo_scene(subdiv=1)
    s = measure_occupancy(scene_np, max_steps=4, probe=16)
    # units include closest+shadow (x2): step 0 alone contributes 2;
    # the cap is 2 per step plus k_volume substeps (0 here)
    assert 2.0 <= s <= 8.0
    s3 = measure_occupancy(scene_np, max_steps=4, probe=16, k_volume=2)
    assert s3 >= s  # substep rays only add


def test_rays_meter():
    from pbrlab_tpu.utils.profiling import RaysMeter

    m = RaysMeter(n_pixels=100, occupancy_steps=3.0)
    with m.lap(spp=2):
        pass
    assert m.rays == 100 * 2 * 3.0 * 2.0
    assert m.seconds > 0
    rep = m.report()
    assert rep["laps"] == 1 and rep["mrays_per_s"] > 0


def test_logger_json_fields(capsys):
    from pbrlab_tpu.utils import log as plog

    logger = plog.get_logger("test")
    logger.setLevel(logging.INFO)
    # swap in a JSON formatter on a capture handler
    import io

    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setFormatter(plog._JsonFormatter())
    root = logging.getLogger("pbrlab_tpu")
    root.addHandler(h)
    try:
        plog.event(logger, "pass done", pass_id=3, mrays=1.5)
    finally:
        root.removeHandler(h)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["pass_id"] == 3 and rec["mrays"] == 1.5
    assert rec["level"] == "info"


def test_fetch_float_n_rgba():
    """Channel-N texture fetch (Texture::FetchFloatN, texture.h:28-34):
    alpha survives the atlas and bilinear filtering matches numpy."""
    import jax.numpy as jnp

    from pbrlab_tpu.scene.scene import SceneBuilder
    from pbrlab_tpu.scene.textures import fetch_float3, fetch_float_n

    rng = np.random.default_rng(0)
    rgba = rng.random((5, 7, 4)).astype(np.float32)
    rgb = rng.random((3, 4, 3)).astype(np.float32)
    b = SceneBuilder()
    b.add_texture(rgba, "a")
    b.add_texture(rgb, "b")
    scene = b.build()
    atlas = jnp.asarray(scene["texture_atlas"])
    sizes = jnp.asarray(scene["texture_sizes"])
    assert atlas.shape[-1] == 4
    # RGB texture padded with alpha=1
    assert float(np.asarray(atlas)[1, 0, 0, 3]) == 1.0

    u = jnp.asarray(rng.random(64), jnp.float32)
    v = jnp.asarray(rng.random(64), jnp.float32)
    tid = jnp.zeros((64,), jnp.int32)
    got = np.asarray(fetch_float_n(atlas, sizes, tid, u, v))
    assert got.shape == (64, 4)

    # numpy bilinear reference with clamp addressing
    h, w = 5, 7
    x = np.asarray(u) * w - 0.5
    y = np.asarray(v) * h - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def at(xi, yi):
        return rgba[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]

    want = (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(fetch_float3(atlas, sizes, tid, u, v)), want[:, :3],
        rtol=1e-5, atol=1e-6)


def _decode_png(data):
    """Minimal decoder for the unfiltered 8-bit PNGs io.image writes."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color_type = ihdr[:4]
    assert depth == 8
    c = {0: 1, 2: 3, 6: 4}[color_type]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    assert (rows[:, 0] == 0).all()  # filter type None on every scanline
    return rows[:, 1:].reshape(h, w, c)


def test_png_roundtrip(tmp_path):
    """write_png (stdlib zlib/struct) -> decode -> the x256-clamp bytes."""
    from pbrlab_tpu.io.image import encode_png, write_png

    g = np.random.default_rng(0)
    img = g.random((5, 7, 3)).astype(np.float32) * 1.2  # some clip at 255
    path = tmp_path / "x.png"
    write_png(str(path), img)
    got = _decode_png(path.read_bytes())
    want = np.clip(img * 256.0, 0.0, 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    rgba = g.integers(0, 256, (3, 4, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(rgba)), rgba)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper returns it, sets nothing."""
    import jax

    from pbrlab_tpu.utils.compile_cache import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: a fixed .jax_cache directory in the checkout."""
    import os

    import jax

    from pbrlab_tpu.utils.compile_cache import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = configure_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
