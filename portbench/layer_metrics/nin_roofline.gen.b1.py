"""nin_roofline.gen.b1 (%): ``nin_roofline.gen`` read in the batch-1 cell, whose step time
is the host-bound ``ms_per_sample_step.b1`` (it spreads too widely from run to
run for the bound of the batched cells' ``ms_per_sample_step``)."""

from portbench.harness import reader

read = reader('nin_roofline.gen')
