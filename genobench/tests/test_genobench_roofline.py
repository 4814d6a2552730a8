"""The vote's bytes against a hand count, and the counting vote entry
against the records it was given."""

import torch

from genobench import roofline
from genobench.harness import VoteCounter


def test_vote_bytes_hand_count():
    # 4 reads, records E = 4, event counts 3, 0, 5 (clamped to 4), 2:
    # 9 records of an idx and a meta word (16 B); a read's count read
    # (8 B), its process byte and target word written (9 B); one
    # overflow word
    assert roofline.vote_bytes(4, 3 + 0 + 4 + 2) == 9 * 16 + 4 * 17 + 8
    assert roofline.vote_ops(9) == 9
    b = roofline.vote_bound_s([(4, 9)])
    assert b == 220 / 3.35e12


def test_vote_counter_counts_clamped_events():
    calls = []

    def vote(ev_idx, meta, ev_total, C):
        calls.append(C)
        return "out"

    v = VoteCounter(vote)
    idx = torch.zeros(4, 4, dtype=torch.int64)
    total = torch.tensor([3, 0, 5, 2])
    assert v(idx, idx, total, 8) == "out"
    v.counting = True
    v(idx, idx, total, 8)
    assert v.launches == 2 and calls == [8, 8]
    assert v.launch_events() == [(4, 9)]
