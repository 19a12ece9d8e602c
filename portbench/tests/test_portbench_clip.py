"""The seeded clip: the same for the same seed, another for another, and
moving as the traffic says."""
import numpy as np

from portbench.clip import checksum, make_segment


def test_same_seed_same_clip():
    a = make_segment(2**31 + 11, 96, 64, 6, device="cpu")
    b = make_segment(2**31 + 11, 96, 64, 6, device="cpu")
    assert checksum(a) == checksum(b)


def test_other_seed_other_clip():
    a = make_segment(5, 96, 64, 6, device="cpu")
    b = make_segment(6, 96, 64, 6, device="cpu")
    assert checksum(a) != checksum(b)


def test_frames_are_i420_and_move():
    frames = make_segment(123, 176, 144, 8, device="cpu")
    assert len(frames) == 8
    assert all(f.dtype == np.uint8 and f.shape == (176 * 144 * 3 // 2,)
               for f in frames)
    y0 = frames[0][:176 * 144].astype(int)
    y7 = frames[7][:176 * 144].astype(int)
    # the pan moves the picture by well over the noise
    assert np.abs(y7 - y0).mean() > 6


def test_noise_is_bounded():
    a = make_segment(9, 96, 64, 2, noise=0, device="cpu")
    b = make_segment(9, 96, 64, 2, noise=3, device="cpu")
    d = np.abs(a[0].astype(int) - b[0].astype(int))
    assert d.max() <= 3 and d.max() > 0
