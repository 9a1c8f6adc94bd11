"""Kernel Q's tiling, chosen in Python (``ops/int8_conv.py``): the tile
rectangle of output pixels (``conv_tiles``) and the channel pad of the K
layout (``padded_channels``), at the 20 shapes one CFG eval of the W8A8
UNet gives Q (``chip_smoke.py`` phase 25) and at every shape of the card
tests' ``Q_CASES`` (``tests/test_torch_cuda.py``).

The kernel (``csrc/int8_conv.cu``) walks tile i as image n, rectangle
(rh, rw) and column tile i % ceil(O / 320); its A box for tap (ky, kx)
starts at (ho0 stride + ky - 1, wo0 stride + kx - 1) and takes every
stride-th pixel. These tests hold that walk to the convolution: every
output pixel in exactly one tile, every box where TMA can take it.
"""

import numpy as np
import pytest

from street_crafter_tpu_torch.ops import int8_conv as Q

# N, C, O, H, W, stride: the convolutions of one CFG eval (2 x 25 frames at
# the 72x128 latent; phase 25's record of what layers.quant_conv is given)
EVAL_SHAPES = [
    (50, 320, 320, 72, 128, 1), (50, 320, 320, 72, 128, 2),
    (50, 320, 640, 36, 64, 1), (50, 640, 640, 36, 64, 1),
    (50, 640, 640, 36, 64, 2), (50, 640, 1280, 18, 32, 1),
    (50, 1280, 1280, 18, 32, 1), (50, 1280, 1280, 18, 32, 2),
    (50, 1280, 1280, 9, 16, 1), (50, 2560, 1280, 9, 16, 1),
    (50, 2560, 1280, 18, 32, 1), (50, 1920, 1280, 18, 32, 1),
    (50, 1280, 1280, 36, 64, 1), (50, 1920, 640, 36, 64, 1),
    (50, 1280, 640, 36, 64, 1), (50, 960, 640, 36, 64, 1),
    (50, 640, 640, 72, 128, 1), (50, 960, 320, 72, 128, 1),
    (50, 640, 320, 72, 128, 1), (50, 1280, 1280, 18, 32, 1)]

# tests/test_torch_cuda.py's Q_CASES, without the layout and dtype
CARD_SHAPES = [
    (2, 5, 6, 7, 9, 1), (3, 37, 13, 9, 11, 2), (2, 64, 130, 17, 33, 1),
    (1, 300, 40, 8, 8, 2), (4, 320, 320, 18, 32, 1),
    (2, 960, 640, 9, 16, 1), (2, 1280, 1280, 9, 16, 2),
    (2, 64, 320, 9, 16, 1), (3, 128, 160, 9, 16, 2),
    (1, 64, 320, 72, 100, 1), (1, 64, 160, 72, 100, 2),
    (2, 320, 320, 36, 64, 2), (1, 640, 1280, 18, 32, 1),
    (1, 960, 640, 18, 32, 1), (1, 1920, 1280, 9, 16, 1),
    (2, 320, 320, 72, 128, 1), (2, 640, 640, 72, 128, 1)]


def walk(N, Ho, Wo, th, tw):
    """The kernel's rectangles in its tile order (column tiles aside):
    (n, ho0, wo0) for rectangle index mt = (n rows_t + rh) cols_t + rw."""
    rows_t, cols_t = -(-Ho // th), -(-Wo // tw)
    for mt in range(N * rows_t * cols_t):
        rw, r = mt % cols_t, mt // cols_t
        yield r // rows_t, th * (r % rows_t), tw * rw


@pytest.mark.parametrize("N,C,O,H,W,stride", EVAL_SHAPES + CARD_SHAPES)
def test_tiles_cover_every_output_pixel_once(N, C, O, H, W, stride):
    Ho, Wo = Q.out_size(H, stride), Q.out_size(W, stride)
    th, tw = Q.conv_tiles(Ho, Wo)
    assert th * tw == Q.TILE_PIXELS and tw in Q.TILE_WIDTHS
    # the A box of a tap: tw stride x th stride elements, at most 256 a dim
    assert tw * stride <= 256 and th * stride <= 256
    hits = np.zeros((min(N, 2), Ho, Wo), np.int32)
    for n, ho0, wo0 in walk(min(N, 2), Ho, Wo, th, tw):
        assert 0 <= ho0 < Ho and 0 <= wo0 < Wo
        hits[n, ho0:ho0 + th, wo0:wo0 + tw] += 1
        for ky in range(3):
            for kx in range(3):
                hi, wi = ho0 * stride + ky - 1, wo0 * stride + kx - 1
                # the first tap inside the padded image; no tap past its
                # last padding row or column
                if ky == kx == 0:
                    assert -1 <= hi < H and -1 <= wi < W
                assert -1 <= hi <= H and -1 <= wi <= W
    assert (hits == 1).all()


@pytest.mark.parametrize("N,C,O,H,W,stride", EVAL_SHAPES + CARD_SHAPES)
def test_channel_pad_is_whole_k_slices(N, C, O, H, W, stride):
    Cp = Q.padded_channels(C)
    assert Cp % 64 == 0 and C <= Cp < C + 64


@pytest.mark.parametrize("hw,want", [((72, 128), (1, 128)),
                                     ((36, 64), (2, 64)),
                                     ((18, 32), (4, 32)),
                                     ((9, 16), (8, 16))])
def test_latent_levels_take_whole_rows(hw, want):
    """At the UNet's latent levels a tile is whole rows of the image (the
    widest rectangle that leaves no column of a tile empty)."""
    assert Q.conv_tiles(*hw) == want
