"""Real multi-process mesh: 2 processes x 4 fake CPU devices render the
same film as a single process (SURVEY.md §2.9 multi-host story;
BASELINE.md scaling row's correctness half).

Each child calls parallel.multihost.init_from_env() ->
jax.distributed.initialize, builds the global 8-device mesh, renders a
tiny scene with render_sharded, and dumps the (replicated) film from its
own addressable shard. The parent asserts both processes agree with each
other and with a single-process 8-fake-device render.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from goblin_tpu.parallel import multihost
assert multihost.init_from_env(), "distributed init did not run"
import numpy as np
from goblin_tpu.scene.loader import load_scene
from goblin_tpu.integrators.path import make_li
from goblin_tpu.parallel import mesh as pmesh

scene, meta = load_scene({scene!r})
mesh = pmesh.make_mesh()
assert len(jax.devices()) == 8, jax.devices()
img = pmesh.render_sharded(scene, meta, make_li(meta), mesh, spp=1,
                           chunk_size=256)
np.save({out!r} + f".p{{jax.process_index()}}.npy", np.asarray(img))
print("proc", jax.process_index(), "ok")
"""


def _tiny_scene(tmp_path):
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1, "max_ray_depth": 2},
        "camera": {
            "position": [0, 1.0, -3.0], "euler": [15, 0, 0],
            "rotation_order": "xyz", "fov": 50.0,
            "film": {"resolution": [16, 12]},
            "filter": {"type": "box", "width": [0.5, 0.5]},
        },
        "geometries": [
            {"name": "floor", "type": "mesh", "file": "plane.obj"},
        ],
        "textures": [
            {"format": "color", "name": "white", "type": "constant",
             "color": [0.8, 0.8, 0.8]},
        ],
        "materials": [
            {"name": "diffuse", "type": "lambert", "Kd": "white"},
        ],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "diffuse"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [8, 8, 8]},
        ],
        "lights": [
            {"name": "key", "type": "point", "intensity": [10, 10, 10],
             "position": [2, 4, -2]},
        ],
    }
    with open(os.path.join(tmp_path, "plane.obj"), "w") as f:
        f.write(
            "v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
            "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n"
        )
    p = os.path.join(tmp_path, "scene.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    return p


@pytest.mark.slow
def test_two_process_mesh_matches_single(tmp_path):
    scene_path = _tiny_scene(str(tmp_path))
    out = os.path.join(str(tmp_path), "film")
    child = CHILD.format(repo=REPO, scene=scene_path, out=out)
    script = os.path.join(str(tmp_path), "child.py")
    with open(script, "w") as f:
        f.write(child)

    from goblin_tpu.parallel.multihost import launch_local

    from goblin_tpu import runtime

    results = launch_local(2, [script], port=7731, devices_per_proc=4,
                           env_extra={
                               "JAX_COMPILATION_CACHE_DIR":
                                   runtime.enable_compile_cache(),
                               "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1",
                               "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0.0",
                           })
    for rc, log in results:
        assert rc == 0, f"child failed:\n{log[-3000:]}"

    img0 = np.load(out + ".p0.npy")
    img1 = np.load(out + ".p1.npy")
    # replicated film: both processes hold the identical global result
    np.testing.assert_allclose(img0, img1, atol=1e-6)

    # single-process reference on the same 8-device (fake) mesh
    from goblin_tpu.integrators.path import make_li
    from goblin_tpu.parallel import mesh as pmesh
    from goblin_tpu.scene.loader import load_scene

    scene, meta = load_scene(scene_path)
    mesh = pmesh.make_mesh(8)
    ref = np.asarray(
        pmesh.render_sharded(scene, meta, make_li(meta), mesh, spp=1,
                             chunk_size=256)
    )
    np.testing.assert_allclose(img0, ref, atol=1e-5)
