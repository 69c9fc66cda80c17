"""Launches of the program's hand-written f32 convolution a train step (a
kernel-4 Conv2d's forward or a ConvTranspose2d's input gradient): the
program's dip.hand.direct2d spans over the window's steps, from the trace.
A program that opens no such span reads nothing."""

from portbench import spans


def read(w):
    n = spans.count(w.trace, "dip.hand.direct2d")
    return n / w.steps if n and w.steps else None
