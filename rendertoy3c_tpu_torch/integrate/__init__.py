from .config import RenderConfig
from .path import RenderStats, make_render_fn, render_frame, render_subframe
