from .intersect import (Hit, ray_triangle, trace_any_bruteforce,
                        trace_closest_bruteforce)
