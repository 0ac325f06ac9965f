"""The fused pipeline with its megakernel split, for the tests of the
non-merged K5 (the CPU ones and the CUDA ones, which must not import
jax)."""
from rendertoy3c_tpu_torch.trace import shade


class SplitPipeline(shade.FusedPipeline):
    """The fused pipeline with K5 split as the reference's
    make_fused_shader(merged=False) splits it: closest_raw (K1, or K3 for
    2 keys), then the non-merged K5."""

    def trace_shade(self, rays, misc, count, time=None):
        hit4 = self.closest_raw(rays, count, time)
        return shade.trace_shade_hit(rays, hit4, misc, count, self.tables,
                                     self.config)
