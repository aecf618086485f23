"""Megatron-style tensor parallelism of the fusion network's wide modules
over the mesh's "model" axis (what GSPMD derives in the JAX package from
`parallel/sharding.py`'s rules, written out here).

`parallel.sharding.apply_tensor_parallel` turns a whole module into one of
these in place: the class changes, the projections named by
`sharding.spec_for` are replaced by this rank's shard, each a contiguous
Parameter of its own, and every other parameter stays whole (replicated).
`shards` maps each sharded parameter to (dim, blocks): the torch dim it is
cut along, and how many equal blocks along it are each cut over the ranks
(in_proj holds its x half's and its z half's slice of the same channels).

  * SS2D / SS2DCross: in_proj (in_proj1, in_proj2) column-parallel, the
    dwconv and the scan on this rank's channels of d_inner (the conv's, the
    dt projection's, A's and D's channels sliced at use), x_proj's product
    summed over the ranks, y and the gate gathered whole before out_norm so
    that the LN runs at its full width, then out_proj row-parallel on this
    rank's channels (or whole, where the >= 128 rule leaves it whole).
    With scan_impl "sp" the channels are gathered after the dwconv instead,
    and the scan runs whole with its sequence split over the same axis.
  * Mlp: the fused MLP kernels on W1's column shard and W2's row shard; b2
    added on the axis' first rank before the sum.
  * PatchExpand/FinalPatchExpand's expand: column-parallel, its output
    gathered (a depth-to-space and an LN follow).

A module's input and output are whole on every rank of the axis.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..nn.layers import Mlp
from ..nn.ss2d import SS2D, SS2DCross, SSMCore
from ..ops import depthwise_conv3x3, fused_mlp
from .collectives import all_gather, all_reduce, first_rank_only, replicate, scatter


class _SSMShard(SSMCore):
    """The channel-sharded scan pipeline shared by both SS2D kinds."""

    def _sp(self) -> bool:
        return self.scan_impl == "sp"

    def scan_params(self):
        whole = super().scan_params()
        if self._sp():
            return whole
        # (K, R+2N, D), (K, D, R), (K, D), (K, D, N), (K, D): channels on dim 2, then 1
        return tuple(scatter(t, 2 if i == 0 else 1, self.axis) for i, t in enumerate(whole))

    def sum_channels(self, x_dbl):
        return x_dbl if self._sp() else all_reduce(x_dbl, self.axis, backward="sum")

    def norm_gated(self, y, gate, gate_act: str):
        if not self._sp():
            y = all_gather(y, -1, self.axis)
            gate = all_gather(gate, -1, self.axis)
        return self.out_norm(y, gate=gate, gate_act=gate_act)

    def conv_shard(self):
        """This rank's channels of the depthwise conv: ((3, 3, C) weight, bias)."""
        w = scatter(self.conv2d.weight, 0, self.axis)
        return w[:, 0].permute(1, 2, 0), scatter(self.conv2d.bias, 0, self.axis)

    def scan_shard(self, x, gate, gate_act: str):
        """The scan of this rank's channels x (gate alike), whole after the LN."""
        if self._sp():
            x, gate = all_gather(x, -1, self.axis), all_gather(gate, -1, self.axis)
        return self.scan(x, gate, gate_act)

    def project_out(self, y):
        if "out_proj.weight" not in self.shards:
            return self.out_proj(y)
        part = F.linear(scatter(y, -1, self.axis), self.out_proj.weight)
        return all_reduce(part, self.axis)


class SS2DShard(_SSMShard, SS2D):
    def forward(self, x):
        x = replicate(x, self.axis)
        d = self.in_proj.weight.shape[0] // 2
        w, b = self.conv_shard()
        xpart = depthwise_conv3x3(F.linear(x, self.in_proj.weight[:d]), w, b, act="silu")
        z = F.linear(x, self.in_proj.weight[d:])
        return self.project_out(self.scan_shard(xpart, z, "silu"))


class SS2DCrossShard(_SSMShard, SS2DCross):
    def forward(self, x1, x2):
        x1, x2 = replicate(x1, self.axis), replicate(x2, self.axis)
        d = self.in_proj1.weight.shape[0] // 2
        w, b = self.conv_shard()
        x1p = depthwise_conv3x3(F.linear(x1, self.in_proj1.weight[:d]), w, b, act="silu")
        z1 = F.linear(x1, self.in_proj1.weight[d:])
        x2p = depthwise_conv3x3(F.linear(x2, self.in_proj2.weight[:d]), w, b, act="silu")
        fused = x1p * x2p + x1p + x2p
        return self.project_out(self.scan_shard(fused, z1, "silu_sum"))


class MlpShard(Mlp):
    def forward(self, x):
        y = fused_mlp(replicate(x, self.axis), self.fc1.weight.t(), self.fc1.bias,
                      self.fc2.weight.t(), first_rank_only(self.fc2.bias, self.axis))
        return all_reduce(y, self.axis)


class GatheredColumnLinear(nn.Linear):
    """A column-parallel Linear whose output is gathered whole."""

    def forward(self, x):
        return all_gather(F.linear(replicate(x, self.axis), self.weight, self.bias), -1,
                          self.axis)


SHARDED = {SS2D: SS2DShard, SS2DCross: SS2DCrossShard, Mlp: MlpShard,
           nn.Linear: GatheredColumnLinear}
