"""A run with the timed path broken underneath comes out not correct:
each fault a serving cell can have, planted in the program where the
answer is produced, in every request of the window.  The run is the
harness's own (`run.execute`), on the CPU at a small size, held to the
cells' real limits.  (A single entry altered among a request's 2,000 to
8,000 sits inside the int8 cell's noise; a whole answer does not.)"""

from __future__ import annotations

import pytest
import torch

from conftest import REPO, run_cell


def _half_batch(orig):
    """The first half of the batch served; its answers stand in for the
    second half's."""
    def serve(self, images, *a, **kw):
        n = images.shape[0]
        tb, ov, probs = orig(self, images[:n // 2], *a, **kw)
        reps = -(-n // tb.shape[0])
        return tuple(t.repeat(reps, *[1] * (t.dim() - 1))[:n]
                     for t in (tb, ov, probs))
    return serve


def _moved_box(orig):
    """Every box moved right by a fifth of the frame."""
    def serve(self, *a, **kw):
        tb, ov, probs = orig(self, *a, **kw)
        tb = tb.clone()
        tb[..., 0] += 0.2
        return tb, ov, probs
    return serve


def _other_class(orig):
    """Every entry's scores given to other classes (rolled by half the
    classes)."""
    def serve(self, *a, **kw):
        tb, ov, probs = orig(self, *a, **kw)
        return tb, ov, torch.roll(probs, probs.shape[-1] // 2, dims=-1)
    return serve


@pytest.mark.parametrize("kind", ["yolov4", "gaussian"])
@pytest.mark.parametrize("fault", [None, _half_batch, _moved_box,
                                   _other_class])
def test_fault_is_not_correct(tiny_root, monkeypatch, kind, fault):
    from darknet_tpu_torch.nn.network import Network

    root, cells = tiny_root
    if fault is not None:
        monkeypatch.setattr(Network, "submit_detect_device",
                            fault(Network.submit_detect_device))
    out, _metrics, _dev = run_cell(root, cells[kind], seconds=0.5)
    assert out.correct is (fault is None), out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yolov4-608.serve-b8",
                                  "gaussian-yolov3-512-int8.serve-b32"])
@pytest.mark.parametrize("fault", [_half_batch, _moved_box, _other_class])
def test_fault_is_not_correct_on_card(cuda, monkeypatch, cell, fault):
    from darknet_tpu_torch.nn.network import Network

    monkeypatch.setattr(Network, "submit_detect_device",
                        fault(Network.submit_detect_device))
    out, _metrics, _dev = run_cell(REPO, cell, seconds=2.0, device=cuda)
    assert not out.correct, out.checks
