"""goblin_tpu — a differentiable Monte Carlo renderer in JAX for GPUs.

A from-scratch wavefront (batched-stage) re-design of the feature set of the
reference CPU renderer (bachi95/Goblin): AO / Whitted / path tracing with
NEE+MIS / light tracing / BDPT / SPPM integrators, the full BSDF / light /
texture / camera model suite, and the JSON scene schema — built on
jax / XLA / Pallas with sharded ray wavefronts instead of recursive
megakernels over std::thread tiles.

Layering (mirrors SURVEY.md §1, re-architected as batched stages):

    core/        math, stateless sampling, RNG streams
    geometry/    triangle soup, analytic quadrics, OBJ loading
    accel/       LBVH build (host) + vectorized traversal (device)
    ops/         hand-written device kernels (BVH trace, Pallas/Triton)
    scene/       JSON loader -> baked SoA SceneData pytree
    shading/     BSDF table dispatch, textures
    lights/      light table dispatch (point/dir/spot/area/IBL)
    camera/      perspective/ortho cameras, film, filters
    integrators/ wavefront integrators (ao, whitted, path, lt, bdpt, sppm)
    parallel/    device-mesh sharding of the wavefront
    io/          EXR/PPM image IO
"""

__version__ = "0.1.0"
