"""launches_per_forward.gen (count): kernel launches a U-Net forward, the
host's CUDA launch records of the profiled window (names holding
``LaunchKernel``) that start inside the port's ``unet.forward`` spans,
over the window's forwards (``portbench/spans.py``)."""

from portbench.spans import launches_per_forward as read  # noqa: F401
