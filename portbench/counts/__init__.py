"""Frozen work counts: the H100's published peaks, the (FLOP, bytes) of
each kernel of the port, and the FLOPs and kernel calls of one U-Net
forward, worked out from the configuration's shapes. A later change to the
program leaves these as they are."""
