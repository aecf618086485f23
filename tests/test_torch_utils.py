"""The port's `utils/` against the JAX package's: the scan FLOP model and the
parameter count (integers, equal), the logger (file name, format, level by
rank), the trace capture (the program's spans, no operator), and the cost
report counted on the plain path."""
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch import utils as tutils
from fusionmamba_torch import config as tcfg
from fusionmamba_torch.models import VSSMFusion
from fusionmamba_torch.utils import logger as tlogger
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu.models import VSSMFusion as JaxVSSMFusion
from fusionmamba_tpu.utils import flops as jflops
from fusionmamba_tpu.utils import logger as jlogger


@pytest.mark.parametrize("B,L,D,N", [(1, 1, 1, 1), (2, 1024, 192, 16), (12, 16, 1536, 16),
                                     (3, 77, 40, 5)])
@pytest.mark.parametrize("with_D,with_z", [(True, False), (False, True), (True, True)])
def test_flops_selective_scan_matches_jax(B, L, D, N, with_D, with_z):
    got = tutils.flops_selective_scan(B, L, D, N, with_D, with_z)
    assert got == jflops.flops_selective_scan(B, L, D, N, with_D, with_z)
    assert isinstance(got, int)


def test_count_params_matches_jax():
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    params = jax.jit(JaxVSSMFusion(jcfg.test_config()).init)(jax.random.PRNGKey(0), x, x)
    # the port does not build Diff_enhance.lastconv, which the reference's
    # forward never reads; the JAX package does not build it either
    assert tutils.count_params(VSSMFusion(tcfg.test_config())) == jflops.count_params(params["params"])


def test_setup_logger_file_format_and_level_by_rank(tmp_path, monkeypatch):
    log = tutils.setup_logger("port_rank0", str(tmp_path))
    ref = jlogger.setup_logger("jax_rank0", str(tmp_path))
    assert log.level == logging.INFO == ref.level
    fmts = [[h.formatter._fmt for h in lg.handlers] for lg in (log, ref)]
    assert fmts[0] == fmts[1]
    names = sorted(os.listdir(tmp_path))
    assert [n.split("-")[0] for n in names] == ["jax_rank0", "port_rank0"]
    assert all(n.endswith(".log") and len(n.split("-")) == 7 for n in names)
    # another rank of a process group logs errors only
    monkeypatch.setattr(tlogger.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tlogger.dist, "get_rank", lambda: 1)
    assert tutils.setup_logger("port_rank1", str(tmp_path)).level == logging.ERROR
    monkeypatch.setattr(tlogger.dist, "get_rank", lambda: 0)
    assert tutils.rank_log_level() == logging.INFO


def test_trace_writes_a_chrome_trace(tmp_path):
    """The program's spans are in the file, and no operator."""
    net = VSSMFusion(tcfg.test_config()).eval()
    x = torch.rand(1, 16, 16, 1)
    with torch.no_grad(), tutils.trace(str(tmp_path / "tr")):
        net(x, x)
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert '"traceEvents"' in text
    assert '"fusion.forward"' in text and '"fusion.encoder"' in text
    assert "aten::" not in text


def test_model_cost_report_counts_on_the_plain_path():
    net = VSSMFusion(tcfg.test_config())
    x = torch.rand(1, 16, 16, 1)
    got = tutils.model_cost_report(net, x, x)
    assert set(got) == {"params", "flops", "bytes_accessed"}
    assert got["params"] == tutils.count_params(net)
    assert math.isnan(got["bytes_accessed"])
    # the count is of matrix products and convolutions: at least the two
    # patch embeds' convolutions (2 FLOPs a multiply-add), and deterministic
    embed = 2 * 2 * (16 // 4) ** 2 * 16 * 4 * 4
    assert got["flops"] > embed
    assert tutils.model_cost_report(net, x, x)["flops"] == got["flops"]
    assert np.isfinite(got["flops"])
