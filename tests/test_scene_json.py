"""JSON scene description: parsing, name resolution, transforms."""
import json

import numpy as np

from pbrlab_tpu.io.scene_json import (load_render_config, load_scene_json,
                                      transform_matrix)


def test_transform_chain():
    m = transform_matrix([
        {"type": "scale", "scale": [2, 2, 2]},
        {"type": "translate", "translate": [1, 0, 0]},
    ])
    p = m[:3, :3] @ np.asarray([1.0, 1.0, 1.0]) + m[:3, 3]
    np.testing.assert_allclose(p, [3, 2, 2], atol=1e-6)
    r = transform_matrix([{"type": "axis_angle", "axis": [0, 0, 1],
                           "angle": 90}])
    p = r[:3, :3] @ np.asarray([1.0, 0.0, 0.0])
    np.testing.assert_allclose(p, [0, 1, 0], atol=1e-6)


def test_full_scene_json(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "o wall\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
        "o lamp\nv 0 0 1\nv 1 0 1\nv 0 1 1\nf 4 6 5\n")
    desc = {
        "wavefront_objs": [{"filepath": "tri.obj"}],
        "materials": [
            {"type": "cycles_principled_bsdf", "name": "red",
             "base_color": [0.8, 0.1, 0.1], "roughness": 0.3},
        ],
        "lights": [{"type": "area", "name": "key", "emission": [5, 5, 5]}],
        "local_scenes": [{"name": "ls0", "meshes": ["wall"]},
                         {"name": "ls1", "meshes": ["lamp"]}],
        "instances": [
            {"local_scene": "ls0", "materials": ["red"],
             "transform": [{"type": "translate", "translate": [0, 0, -1]}]},
            {"local_scene": "ls1", "lights": ["key"]},
        ],
        "render": {"width": 64, "height": 32, "max_pass": 4},
    }
    jpath = tmp_path / "scene.json"
    jpath.write_text(json.dumps(desc))
    scene, render_cfg = load_scene_json(str(jpath))
    # commit pads face columns to SAH slot windows; count VALID faces
    valid = scene["face_area"] > 0.0
    assert valid.sum() == 2
    assert render_cfg["width"] == 64
    # the wall was translated by (0,0,-1)
    zs = np.sort(scene["tri_v0"][valid][:, 2])
    np.testing.assert_allclose(zs, [-1.0, 1.0], atol=1e-6)
    # one emissive face with the configured emission
    assert scene["emissive_faces"].shape[0] == 1
    em = scene["face_emission"][scene["emissive_faces"][0]]
    np.testing.assert_allclose(em, [5, 5, 5])
    # material override applied to the wall face
    wall_face = int(np.argmin(scene["tri_v0"][:, 2]))
    mid = scene["face_material"][wall_face]
    np.testing.assert_allclose(scene["materials"]["base_color"][mid],
                               [0.8, 0.1, 0.1])


def test_render_config(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"width": 256, "max_pass": 8,
                             "scene_filepaths": ["a.obj"]}))
    cfg = load_render_config(str(p))
    assert cfg.width == 256 and cfg.height == 512
    assert cfg.max_pass == 8
    assert cfg.scene_filepaths == ["a.obj"]


def test_json_shared_instances(tmp_path):
    """Instances repeating a local_scene route through the shared-BLAS
    two-level path (raytracer_impl.cc:49-84 semantics)."""
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "o blockmesh\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
        "o lampmesh\nv 0 0 1\nv 1 0 1\nv 0 1 1\nf 4 6 5\n")
    desc = {
        "wavefront_objs": [{"filepath": "tri.obj"}],
        "materials": [{"type": "cycles_principled_bsdf", "name": "red",
                       "base_color": [0.8, 0.1, 0.1]}],
        "lights": [{"type": "area", "name": "key", "emission": [5, 5, 5]}],
        "local_scenes": [{"name": "block", "meshes": ["blockmesh"]},
                         {"name": "lamp", "meshes": ["lampmesh"]}],
        "instances": [
            {"local_scene": "block", "materials": ["red"],
             "transform": [{"type": "translate", "translate": [x, 0, 0]}]}
            for x in (0.0, 2.0, 4.0)
        ] + [{"local_scene": "lamp", "lights": ["key"]}],
    }
    jpath = tmp_path / "scene.json"
    jpath.write_text(json.dumps(desc))
    scene, _ = load_scene_json(str(jpath))
    assert "tlas_skip" in scene, "shared instances must use the TLAS/BLAS path"
    assert scene["inst_meta"].shape == (4, 3)  # 3 blocks + 1 lamp
    # the three block instances share ONE BLAS: the local triangle table
    # holds only the two local scenes' faces
    assert scene["blas_v0"].shape == (2, 3)
    assert len(np.unique(scene["inst_meta"][:3, 0])) == 1
    assert scene["emissive_faces"].shape[0] == 1
    from pbrlab_tpu.render.integrator import render_sample
    from pbrlab_tpu.scene.scene import scene_to_device

    import jax.numpy as jnp

    img = np.asarray(render_sample(scene_to_device(scene), 8, 8,
                                   jnp.uint32(0), max_steps=3))
    assert np.isfinite(img).all()
