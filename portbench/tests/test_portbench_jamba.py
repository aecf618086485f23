"""The Jamba cell's own pieces on the CPU at its tiny size: the route check
(a flip outside the tie width is counted, one inside it is not), the
reference against the program, and the numbers its configuration file
states."""
import torch

from portbench import build, harness
from portbench.reference import jamba as ref_jamba
from portbench.tests.tiny import tiny_cell

WORKLOAD = "jamba2mini_score_b2_l16384"


def _checked_run():
    cell = tiny_cell(WORKLOAD)
    run = harness.job_module(cell.mix).Run(cell)
    for _ in range(3):
        run.unit()
    run.release()
    return run


def _flip_first_row(run):
    """The program's route of the first kept unit's first row, in its first
    expert layer, turned round: its top 2 become its bottom 2."""
    j, (logits, router_logits) = run.kept[0]
    first = router_logits[0].clone()
    first[0] = -first[0]
    run.kept[0] = (j, (logits, (first,) + router_logits[1:]))


def test_a_route_flipped_outside_the_tie_width_is_counted_and_inside_it_is_not():
    run = _checked_run()
    assert run.check()["route_mismatch"] == 0.0
    _flip_first_row(run)
    run.tau = 1e-12
    assert run.check()["route_mismatch"] >= 1.0
    # every row within the tie width: the reference takes the program's route
    run.tau = 1.0
    assert run.check()["route_mismatch"] == 0.0
    assert run.detail["tie_rows"] == 2 * 4 * 2 * 40


def test_the_reference_matches_the_program():
    cell = tiny_cell(WORKLOAD)
    cfg, held = ref_jamba.model_config(cell.config), ref_jamba.experts_held(cell.config)
    prog = build.model(cell.config, "cpu").eval()
    ref = ref_jamba.JambaLM(cfg, held)
    ref_jamba.load_weights(prog, cfg, 2 ** 31 + 5, "cpu")
    ref_jamba.load_weights(ref, cfg, 2 ** 31 + 5, "cpu")
    assert dict(prog.named_parameters()).keys() == dict(ref.named_parameters()).keys()
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, router_logits = prog(tokens)
        want, routes = ref(tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert len(routes.taken) == len(router_logits) == 4


def test_weights_repeat_from_the_seed_and_an_expert_s_do_not_depend_on_the_share():
    cell = tiny_cell(WORKLOAD)
    cfg = ref_jamba.model_config(cell.config)
    nets = [ref_jamba.JambaLM(cfg, held) for held in (range(0, 4), range(2, 6), range(0, 4))]
    for net, seed in zip(nets, (7, 7, 8)):
        ref_jamba.load_weights(net, cfg, seed, "cpu")
    a, b, c = (dict(n.named_parameters()) for n in nets)
    name = "model.layers.1.feed_forward.experts.3.up_proj.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert torch.equal(a["model.layers.0.mamba.D"], torch.ones_like(a["model.layers.0.mamba.D"]))


def test_configuration_numbers():
    config = harness.load_json(harness.HERE / "configs" / "jamba2_mini_ep2.json")
    cfg, held = ref_jamba.model_config(config), ref_jamba.experts_held(config)
    assert cfg["num_experts"] == 16 and held == range(0, 8)
    net = ref_jamba.JambaLM(cfg, held, device="meta")
    assert sum(p.numel() for p in net.parameters()) == config["parameters"]
    assert ref_jamba.forward_flops_per_token(cfg, len(held), 16384) == \
        config["forward_flops_per_item"]
    prog = build.model(config, "meta")
    assert sum(p.numel() for p in prog.parameters()) == config["parameters"]
