"""rendertoy3c_tpu_torch — the PyTorch + CUDA port of rendertoy3c_tpu.

The JAX package `rendertoy3c_tpu/` is the reference; this package carries
the same path tracer in PyTorch, with every Pallas kernel on its path
rewritten by hand in CUDA C++ for Hopper (`kernels/csrc/`, sm_90a).

This first slice covers the Cornell main path: builtin Cornell box,
persistent pixel-major ray pool over the in-kernel-refill megakernel,
film accumulation, tonemap and PNG output. The implementation is chosen by
the tensor's device: CUDA tensors run the hand-written kernels, CPU tensors
run each kernel's plain PyTorch version. Nothing here imports jax or
rendertoy3c_tpu.

Layer map (JAX counterpart in parentheses):
  math/       tea/LCG streams, sampling, ONB       (rendertoy3c_tpu/math)
  scene/      mesh, material, lights, camera, Cornell builtin, build_scene
                                                   (rendertoy3c_tpu/scene)
  trace/      brute tracer, MT kernels (K1/K2), the refill megakernel (K4),
              tracer choice                        (rendertoy3c_tpu/trace)
  integrate/  RenderConfig, the fused pool loop    (rendertoy3c_tpu/integrate)
  film/       accumulation, ACES/sRGB, PNG         (rendertoy3c_tpu/film)
  kernels/    CUDA sources and their build (nvcc -> ctypes)
  app/        CLI                                  (rendertoy3c_tpu/app/cli.py)
"""

__version__ = "0.1.0"
