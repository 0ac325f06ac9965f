from .film import Film, film_accumulate, film_create
from .image import write_png
from .tonemap import aces_tonemap, make_color, quantize_u8, to_srgb
