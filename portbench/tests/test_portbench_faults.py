"""A run whose timed path is broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (the program
on the CPU, a small cell) with one fault planted in the program's
decoder: a step that returns its state unchanged, half of a call's
pictures left out, an answer altered where it is produced, a frame the
check does not sample decoded wrong.  A sound run of the same cell comes
out correct, and the control in the program's place comes out not
correct by the run's own verdict."""
import pytest

from portbench import harness
from portbench.tests._cells import small_cell

SEED = 2**31 + 1234


def _run(name, **traffic):
    return harness.run_cell(small_cell(name, **traffic), SEED, 0.5, False,
                            device="cpu", workers=2)


def _unchanged(results):
    for prev, r in zip(results, results[1:]):
        r.frame = prev.frame
    return results


def _half(results):
    return results[:len(results) // 2]


def _altered(results):
    for r in results:
        r.frame = r.frame.copy()
        r.frame[0] ^= 1
    return results


def _wrong_unsampled(results):
    """Every picture at an odd place of its call returned wrong: with
    each call's first picture sampled alone, the check reaches these
    only as the picture before a sampled one."""
    for i, r in enumerate(results):
        if i % 2:
            r.frame = r.frame.copy()
            r.frame[:64] = 255 - r.frame[:64]
    return results


def test_decode_sound_run_is_correct():
    r = _run("dec-1080p-ingest")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered,
                                   _wrong_unsampled])
def test_decode_fault_is_caught(monkeypatch, fault):
    from hartallo_tpu_torch.decode.decoder import Decoder
    orig = Decoder.decode_annexb
    monkeypatch.setattr(Decoder, "decode_annexb",
                        lambda self, *a, **k: fault(orig(self, *a, **k)))
    r = _run("dec-1080p-ingest", check_pictures=2)
    assert not r["correct"], r["checks"]


def test_decode_control_in_the_program_place_is_not_correct():
    """The control's frames, judged by the run's own verdict, come out
    not correct where the program's come out correct."""
    cell = small_cell("dec-1080p-ingest", width=176, height=144,
                      segment=4, chunk=2, check_pictures=4, check_after=1)
    r = harness.control_run(cell, SEED, 0.5, device="cpu", workers=2)
    assert r["correct"], r["checks"]
    assert not r["control_correct"], r["control"]
