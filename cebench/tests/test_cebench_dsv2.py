"""Whole runs of ``ce-dsv2lite-yugioh.build`` at a tiny size on the CPU: a
sound run is correct; the control (the reference in float8 e4m3 in the
program's place) and each planted fault are not. On the card (marked
``cuda``) the control and the faults at the cell's own size, against its
own limits.

At the tiny size (hidden 64, 3 layers with the first dense, 8 experts of
which 2 a token and 1 shared, latent 32, nope 16, rope 8, v 16) the cell's
limits do not apply: gaps of every precision differ at another width, so
the tiny limits sit between the program's readings at this size (10 seeds:
widest gap 0.06-0.22, mean 0.018-0.035) and the control's (3 seeds: 0.97-1.64,
0.33-0.44), as the cell's sit between them at its own. The routing fault
moves every entry a little (here 0.36 widest, 0.10 mean): it fails the
mean, as at the cell's size."""

import json

import pytest
import torch

from cebench import control
from cebench.lib import harness

CELL = "ce-dsv2lite-yugioh.build"
SEED = 2**31 + 17

TINY_CONFIG = {
    "vocab_size": 1100, "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
    "intermediate_size": 96, "moe_intermediate_size": 16, "n_routed_experts": 8, "n_shared_experts": 1,
    "num_experts_per_tok": 2, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "random_weight_std": 0.2,
    "deployment": {"max_input_len": 12, "max_label_len": 12, "pair_pad_multiple": 32, "n_items": 200,
                   "bos_id": 1098, "eos_id": 1099},
}
TINY = {
    "config": TINY_CONFIG,
    "params": {"ment_block": 2, "ent_block": 8, "max_pairs_per_program": 32, "slab": 16, "mention_blocks": 200,
               "check_entries": 32},
    "limits": {"score_gap": 0.45, "score_gap_mean": 0.06},
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_run(seconds=1.5):
    return harness.execute(harness.Run(CELL, SEED, seconds, False, "cpu", overrides=TINY))


def test_a_sound_run_is_correct():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"build_pairs_per_s", "setup_s"}


def test_the_control_is_not_correct():
    run = harness.Run(CELL, SEED, 1.5, False, "cpu", overrides=TINY)
    gaps = control.gaps(run)
    assert any(not v <= run.limits[k] for k, v in gaps.items()), gaps


def half_batch_mean(monkeypatch):
    """The second half of every forward's scores replaced by the mean of
    the first half's."""
    from anncur_tpu_torch.models.deepseek_v2 import DeepseekV2CrossEncoder

    fn = DeepseekV2CrossEncoder.score

    def score(self, *a, **kw):
        out = fn(self, *a, **kw).clone()
        half = out.shape[0] // 2
        if half:
            out[half:] = out[:half].mean(0)
        return out

    monkeypatch.setattr(DeepseekV2CrossEncoder, "score", score)


def answer_altered(monkeypatch):
    """Every seventh score replaced by its neighbour's."""
    from anncur_tpu_torch.models.deepseek_v2 import DeepseekV2CrossEncoder

    fn = DeepseekV2CrossEncoder.score

    def score(self, *a, **kw):
        out = fn(self, *a, **kw).clone()
        out[::7] = out.roll(-1, 0)[::7]
        return out

    monkeypatch.setattr(DeepseekV2CrossEncoder, "score", score)


def routing_shifted(monkeypatch):
    """Each token's last expert (the 6th of 6 at full size) replaced by the
    one ranked after it, with that one's weight."""
    import anncur_tpu_torch.models.deepseek_v2 as dsv2
    from anncur_tpu_torch.ops import moe

    def route(x, gate, top_k, scale=1.0):
        ids, weights = moe.route(x, gate, top_k + 1, scale)
        keep = list(range(top_k - 1)) + [top_k]
        return ids[:, keep].contiguous(), weights[:, keep].contiguous()

    monkeypatch.setattr(dsv2, "route", route)


FAULTS = [half_batch_mean, answer_altered, routing_shifted]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = tiny_run()
    assert not res["correct"], res["checks"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_own_size():
    """On the card: the control at the published widths and the cell's
    sizes, three seeds, against the cell's own limits."""
    _card()
    seconds = harness.load_benchmark()["run_seconds"]
    for seed in (101, 2**31 + 3, 77777):
        run = harness.Run(CELL, seed, seconds, False, "cuda:0")
        gaps = control.gaps(run)
        print(json.dumps({"control": CELL, "seed": seed, "gaps": gaps}))
        assert any(not v <= run.limits[k] for k, v in gaps.items()), (seed, gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_fails_at_the_cells_own_size(monkeypatch, fault):
    """On the card: a whole run at the published widths and the cell's own
    sizes, the fault planted in the timed path, judged by the cell's own
    limits (a short window: the check's sample is the same size). The
    routing fault fails ``score_gap_mean`` (0.058 against 0.042), not the
    widest gap: bf16 itself routes some tokens apart from f32."""
    _card()
    fault(monkeypatch)
    res = harness.execute(harness.Run(CELL, 2**31 + 101, 12, False, "cuda:0"))
    print(json.dumps({"fault": fault.__name__, "cell": CELL, "checks": res["checks"]}))
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 202, 2**31 + 303, 2**31 + 404, 90210, 424242])
def test_the_routing_fault_fails_on_more_seeds_at_the_cells_own_size(monkeypatch, seed):
    """On the card: the routing fault at the cell's own size on five more
    seeds. It moves every entry about as much as bf16's own near-tie
    flips move some, so its margin over ``score_gap_mean``'s limit is read
    on each seed rather than trusted from one."""
    _card()
    routing_shifted(monkeypatch)
    res = harness.execute(harness.Run(CELL, seed, 12, False, "cuda:0"))
    print(json.dumps({"fault": "routing_shifted", "seed": seed, "cell": CELL, "checks": res["checks"]}))
    assert not res["correct"], res["checks"]
