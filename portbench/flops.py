"""The network's FLOPs, counted from its layer shapes.

2 FLOPs per multiply-add of every convolution, transposed convolution
(16 taps a 4x4 input pixel) and dense layer, one sample and one
iteration.  The backward takes twice the forward (the input and the
weight gradients) less conv1's input gradient, which nothing needs.  The
flatten head sees the full-size grid at any input size (the bottleneck is
resized to it), so fc1's width is fixed by ``head_grid``.  FLOPs of the
renders, the zoom and the losses are not counted.
"""

from __future__ import annotations

from portbench.reference.network import DECODER, ENCODER, SKIPS


def network_flops(size, head_grid, decoder: bool, mask: bool, num_classes: int,
                  fc_dim: int = 1024, cin: int = 6) -> tuple[float, float]:
    """(forward, forward + backward) FLOPs of one sample and iteration at ``size``."""
    h, w = size
    fwd, sizes, ch, conv1 = 0.0, {}, {}, 0.0
    for name, cout, k, s in ENCODER:
        h, w = -(-h // s), -(-w // s)
        sizes[name], ch[name] = (h, w), cout
        flops = 2.0 * cin * cout * k * k * h * w
        conv1 = conv1 or flops
        fwd += flops
        cin = cout
    if decoder or mask:
        h, w = sizes["conv6_1"]
        fwd += 2.0 * cin * 2 * 9 * h * w
        for lvl, cout in DECODER:
            fwd += 2.0 * cin * cout * 16 * h * w + 2.0 * 2 * 2 * 16 * h * w
            h, w = sizes[SKIPS[lvl]]
            cin = ch[SKIPS[lvl]] + cout + 2
            fwd += 2.0 * cin * 2 * 9 * h * w
        if mask:
            fwd += 2.0 * (cin * 64 + 64) * 9 * h * w
    flat = ch["conv6_1"] * head_grid[0] * head_grid[1]
    for n_in, n_out in ((flat, fc_dim), (fc_dim, fc_dim), (fc_dim, 4 * num_classes),
                        (fc_dim, 3 * num_classes)):
        fwd += 2.0 * n_in * n_out
    return fwd, 3.0 * fwd - conv1


def refine_flops(size, coarse_size, iters: int, coarse_iters: int, head_grid,
                 num_classes: int) -> float:
    """Forward FLOPs of one pose refined ``iters`` times, the first
    ``coarse_iters`` at ``coarse_size``."""
    full = network_flops(size, head_grid, False, False, num_classes)[0]
    coarse = network_flops(coarse_size, head_grid, False, False, num_classes)[0]
    return coarse_iters * coarse + (iters - coarse_iters) * full
