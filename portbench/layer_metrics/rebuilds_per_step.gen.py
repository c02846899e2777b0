"""rebuilds_per_step.gen (count): things the port built again inside the
profiled window, a step: its ``rebuild.*`` instants (a conv's weights
repacked or relaid, a launch plan made, a kernel scratch grown, a Triton
specialization compiled, the nvcc library built or loaded), over the
window's steps (``portbench/spans.py``). Warm-up builds everything, so a
steady window reads 0."""

from portbench.spans import rebuilds_per_step as read  # noqa: F401
