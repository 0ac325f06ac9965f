"""Asset loading and generation (port of rendertoy3c_tpu/io)."""
from .genassets import generate_town
from .obj import load_obj, parse_mtl
