"""Host-side face ordering (port of rendertoy3c_tpu/accel)."""
from .lbvh import morton_order_scene, reorder_scene_by_bvh
from .morton import morton3d_np
