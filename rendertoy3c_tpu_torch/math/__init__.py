from .rng import lcg, rnd, rnd_masked, rot_seed, tea
