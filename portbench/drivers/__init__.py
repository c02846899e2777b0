"""One module a driver kind, named by a traffic mix's ``driver``; each has
``run(cell, seed, seconds, trace, device, t_start) -> harness.Outcome``."""
