from .intersect import (Hit, make_bruteforce_tracer, ray_triangle,
                        trace_any_bruteforce, trace_closest_bruteforce)
