"""idle_ops_ms.gen.b1 (ms): ``idle_ops_ms.gen`` read in the batch-1 cell, whose step time
is the host-bound ``ms_per_sample_step.b1`` (it spreads too widely from run to
run for the bound of the batched cells' ``ms_per_sample_step``)."""

from portbench.harness import reader

read = reader('idle_ops_ms.gen')
