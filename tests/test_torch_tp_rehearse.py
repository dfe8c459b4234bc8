"""``chip_smoke.py``'s phase 10 rehearsed on the CPU: gloo worlds of 2
and 4 processes over the tiny configs computing in bf16, as the card run
computes at full width (``rehearse=True``).  rwkv6-7b and
recurrentgemma-9b (a 20-token prompt over its window of 16) are served
split two ways: the state committed, restored on the mesh equal to a
second prefill and decoding to the live tokens, restored whole on one
rank equal to every rank's box, one committed part a distinct box, the
all-reduces counted (``rnn_tp_all_reduces``); their f32 cuts' logits,
greedy tokens, loss and gradient shards held to the one-process plain
path (logits within ``TP_PLAIN_ATOL``, every leaf within ``GRAD_TOL`` of
its largest); the split bf16 logits within ``TP_BF16_BOUND`` times
bf16's own distance from f32.  phi3-medium-14b's f32 cut is split four
ways the same (its 5 heads do not divide 4: q is gathered whole and
``o`` sliced to ``wo``'s rows).  Phase 11 the same way: tiny dbrx-132b
and qwen3-moe under ``FSDP_RULES`` served split two ways (their experts
over "model"), committed and restored, the split bf16 logits held to
one process's, both routed by the split run's expert ids, and the
split's router probabilities and choices held to one process's; qwen3-moe's
f32 cut on a ("data" 2, "model" 2) mesh (its embed rows over "data",
gathered a layer at a time) against the plain path.  The phases raise
on any failed check; these tests read their numbers."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


LINES = {"rwkv6-7b": "serve_tp_rwkv6",
         "recurrentgemma-9b": "serve_tp_recurrentgemma"}


@pytest.fixture(scope="module")
def lines():
    return chip_smoke.tp10_phase(CPU, "cpu", rehearse=True)


@pytest.mark.parametrize("arch", chip_smoke.RNN_TP_ARCHS)
def test_rehearsed_recurrent_split_serving(lines, arch):
    line = lines[LINES[arch]]
    cfg = chip_smoke.tp_config(arch, rehearse=True)
    sizes = chip_smoke._tp10_sizes(True)
    per_step = chip_smoke.rnn_tp_all_reduces(cfg)
    assert (line["all_reduces_prefill"], line["all_reduces_decode_step"],
            line["all_reduces_generate"]) == (per_step - 2, per_step,
                                              per_step * sizes["gen"])
    # the state's leaves split over "model" commit as two parts, the
    # whole ones (the shift states, the ring caches, the index) as one
    assert line["parts"]["idx"] == 1
    assert set(line["parts"].values()) == {1, 2}
    assert line["whole_decode_equal_tokens"] == sizes["batch"] * (
        sizes["gen"] - 1)
    assert line["plain_cut_max_abs_err"] <= chip_smoke.TP_PLAIN_ATOL
    assert line["plain_cut_grads"]["worst_leaf_err_of_max"] <= \
        chip_smoke.GRAD_TOL
    assert line["logits_rel_err_vs_one_process_bf16"] <= line["logits_bound"]


def test_rehearsed_phi3_split_four_ways(lines):
    phi3 = lines["tp_phi3"]
    assert phi3["ranks"] == 4
    assert phi3["plain_cut_max_abs_err"] <= chip_smoke.TP_PLAIN_ATOL
    assert phi3["plain_cut_grads"]["worst_leaf_err_of_max"] <= \
        chip_smoke.TP_GRAD_TOL
    assert phi3["plain_cut_grads"]["loss_rel_err"] <= chip_smoke.LOSS_RTOL


@pytest.fixture(scope="module")
def moe_lines():
    return chip_smoke.moe_phase(CPU, "cpu", rehearse=True)


@pytest.mark.parametrize("arch", chip_smoke.MOE_TP_ARCHS)
def test_rehearsed_moe_split_serving(moe_lines, arch):
    line = moe_lines["serve_tp_moe"][arch]
    cfg = chip_smoke.moe_tp_config(arch, rehearse=True)
    sizes = chip_smoke._moe_sizes(True)
    # two all-reduces a layer (the attention's output, the experts'
    # gather), the embedding's, the greedy argmax's two
    per_step = 2 * cfg.num_layers + 3
    assert (line["all_reduces_prefill"], line["all_reduces_decode_step"],
            line["all_reduces_generate"]) == (per_step - 2, per_step,
                                              per_step * sizes["gen"])
    assert line["local_experts"] == cfg.num_experts // 2
    # the largest collective of a prefill is the experts' gather
    assert line["prefill_collectives"]["model"]["largest_bytes"] == \
        line["ye_gather_bytes_per_layer_prefill"]
    assert line["parts"]["idx"] == 1
    assert set(line["parts"].values()) == {1, 2}
    assert line["whole_decode_equal_tokens"] == sizes["batch"] * (
        sizes["gen"] - 1)
    assert line["logits_rel_err_vs_one_process_bf16"] <= line["logits_bound"]
    # the split's routers against one process's on the same routes
    flips = line["route_flips_vs_one_process"]
    assert flips["router_err_split_vs_one"] <= flips["router_err_bound"]
    assert flips["largest_margin_reversed"] <= flips["margin_bound"]
    assert flips["flipped_tokens"] <= chip_smoke.MOE_TP_BF16_BOUND * \
        flips["flipped_tokens_bf16_vs_f32"]


def test_rehearsed_fsdp_cut(moe_lines):
    line = moe_lines["fsdp_qwen3_moe"]
    assert line["mesh"] == [2, 2] and line["rules"] == "fsdp"
    assert line["plain_cut_max_abs_err"] <= chip_smoke.TP_PLAIN_ATOL
    assert line["plain_cut_grads"]["worst_leaf_err_of_max"] <= \
        chip_smoke.TP_GRAD_TOL
    assert line["plain_cut_grads"]["loss_rel_err"] <= chip_smoke.LOSS_RTOL
    # every layer's eight embed-split leaves and the embedding, the final
    # norm and the LM head, gathered once a forward
    assert line["data_gathers_per_forward"] == 8 + 3
    # one broadcast a data rank a gather, no all-reduce over "data"
    data = line["serve_collectives"]["data"]
    assert (data["broadcasts"], data["calls"]) == (
        line["data_gathers_per_forward"] * 2
        * (chip_smoke.CUT_STEPS_FSDP + 1), 0)
