"""arctic_tpu — a forward PBR render engine in JAX for NVIDIA GPUs.

A from-scratch re-design of the capabilities of the Arctic DX12 renderer
(reference: novara754/arctic-renderer) for one or more CUDA GPUs (README.md
says where the package name comes from):

- Geometry, lights and camera live as device-resident ``jax.Array`` pytrees
  (replacing D3D12 buffers/descriptor heaps, reference src/renderer/rhi.cpp).
- The whole frame — shadow-map depth pass, forward Cook-Torrance PBR with
  25-tap PCF shadows, equirectangular skybox, HDR tonemap + gamma — is one
  jit-compiled function with no host round-trips (replacing the command-list
  frame graph in reference src/renderer/renderer.cpp:274-415).
- Rasterization is done in software: triangle setup produces screen-space
  edge/depth plane coefficients, tiles are binned via sort/searchsorted, and
  a Pallas kernel (Triton route) runs one program per screen tile, keeping
  the tile's depth and winning triangle in registers.
- Shading reads a per-pixel G-buffer resolved from the winning slot ids, so
  the PBR math runs once per covered pixel as fused XLA elementwise code.

Layout:
    core/      math + scene/settings data model (reference scene.{hpp,cpp})
    io/        glTF / OBJ / PNG / Radiance-HDR loaders (reference app.cpp:173-385)
    ops/       rasterizer, binning, sampling, PBR, shadow, tonemap kernels
    models/    render pipelines (frame graph) + golden CPU reference renderer
    parallel/  multi-device tile sharding over a jax.sharding.Mesh
    utils/     profiling, logging, framebuffer helpers
    app/       CLI, fly-camera controller, offline viewer
"""

__version__ = "0.1.0"
