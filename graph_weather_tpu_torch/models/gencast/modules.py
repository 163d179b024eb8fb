"""GenCast building blocks (port of graph_weather_tpu/models/gencast/modules.py).

  * GenCastMLP: hidden_dims-list MLP, SiLU between layers, final LayerNorm.
  * InteractionNetwork: directed bipartite message passing with add
    aggregation and a message scale factor.
  * FourierEmbedding: sin/cos features of the (log-)noise level + SiLU MLP.
  * ConditionalLayerNorm: LayerNorm without affine, scale and bias computed
    as Linears of the conditioning vector.
  * GraphTransformerConv: UniMP-style multi-head graph attention with beta
    gating; segment-softmax branch (with edge features), the clustered
    branch, which runs the kernel K3a forward and K3c (symmetric graphs) or
    K3b backward (ops/clustered_flash.py), and the banded branch: the
    kernels K4a/K4b (ops/banded_flash.py) or the plain banded attention
    (ops/banded_attention.py).
  * CondTransformerBlock: the conv, the conditional norm and the activation.

bf16 compute policy (Denoiser.forward_fn(compute_dtype=torch.bfloat16)):
the modules run on bf16 parameters (which is how they know the policy is
on) and bf16 activations, rounded where the JAX package's run rounds them.
XLA rounds every bf16 operation's result to bf16, with one exception: an
elementwise operation whose only use is an upcast to f32 is computed in f32
and not rounded. So:
  * SiLU and the beta gate's sigmoid are x * (1 / (1 + exp(-x))), one
    rounded operation at a time, and so are their gradients, as JAX
    differentiates them (`nn.bf16.silu`, `nn.bf16.sigmoid`);
  * a GenCastMLP's last bias add and the beta gate's last add, whose only
    use is a LayerNorm's f32 statistics, stay f32 (`wide`);
  * the LayerNorms' statistics and affine are f32, rounded once;
  * the FourierEmbedding, and so the conditional norms' scale and bias, is
    f32 from the f32 noise level; the conditional norm rounds its
    normalised x to bf16 before that f32 affine, then rounds the result;
  * the segment branch's logits sum f32 products, rounded once.
f32 runs are unchanged.

PyTorch needs every input width at construction, where flax infers them, so
each module takes its input widths. Submodules carry the flax auto-names
(GenCastMLP_0/TorchLinear_0, GraphTransformerConv_0, ...) so converted
parameters load with convert.from_jax_params. All modules are batch-aware
over [..., N, F] with shared static graphs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from graph_weather_tpu_torch.nn.bf16 import Bf16LayerNorm, layer_norm, sigmoid, silu
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph, _GatherSumLinear
from graph_weather_tpu_torch.nn.mlp import TorchLinear
from graph_weather_tpu_torch.ops.banded_attention import banded_graph_attention
from graph_weather_tpu_torch.ops.banded_flash import banded_flash_attention
from graph_weather_tpu_torch.ops.clustered_flash import clustered_flash_attention
from graph_weather_tpu_torch.ops.segment_softmax import segment_softmax

# Where each GenCast option the port does not run yet is queued.
GENCAST_TODO = "ROADMAP.md, 'GenCast options not yet ported'"


def cluster_pad_rows(x: torch.Tensor, graph: DeviceGraph) -> torch.Tensor:
    """Pad [..., N, F] rows with zeros to the clustered layout's nb * block.

    Processors pad once before their transformer stack and slice once
    after. Padded receiver rows have all-zero mask rows (exact-zero
    attention output) and are never senders, so real rows are unaffected.
    """
    if graph.cluster_ids is None:
        return x
    pad = graph.cluster_ids.shape[0] * graph.cluster_block - x.shape[-2]
    if pad <= 0:
        return x
    return F.pad(x, (0, 0, 0, pad))


def cluster_unpad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Slice [..., N_pad, F] back to the first n real rows."""
    return x[..., :n, :]


class GenCastMLP(nn.Module):
    """MLP over a hidden_dims list, SiLU between layers, LayerNorm (eps 1e-5)
    on the output: every GenCast MLP of the denoiser is built this way."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int]):
        super().__init__()
        self.n_layers = len(hidden_dims)
        width = in_dim
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"TorchLinear_{i}", TorchLinear(width, dim))
            width = dim
        self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x) -> torch.Tensor:
        wide = self.LayerNorm_0.weight.dtype == torch.bfloat16  # the last layer's, for the norm
        for i in range(self.n_layers):
            linear = getattr(self, f"TorchLinear_{i}")
            x = linear(x if i == 0 else silu(x), wide=wide and i == self.n_layers - 1)
        return layer_norm(self.LayerNorm_0, x)


class _FactorizedGenCastMLP(GenCastMLP):
    """GenCastMLP whose first layer is a _GatherSumLinear over parts: the
    [E, sum(widths)] concatenation never materializes, node partial products
    are taken per node and then gathered. Called with the parts."""

    def __init__(self, widths: Sequence[int], hidden_dims: Sequence[int]):
        super().__init__(sum(widths), hidden_dims)
        self.TorchLinear_0 = _GatherSumLinear(widths, hidden_dims[0])


class InteractionNetwork(nn.Module):
    """e'_ij = scale * MLP([v_i, v_j, e_ij]); v'_j = MLP([v_j, sum_i e'_ij]).

    Directed source->target flow on a bipartite static graph; the edges are
    not updated.
    """

    def __init__(
        self,
        src_dim: int,
        dst_dim: int,
        edge_dim: int,
        hidden_dims: Sequence[int],
        scale_factor: float = 1.0,
    ):
        super().__init__()
        self.scale_factor = scale_factor
        self.GenCastMLP_0 = _FactorizedGenCastMLP((src_dim, dst_dim, edge_dim), hidden_dims)
        self.GenCastMLP_1 = GenCastMLP(dst_dim + hidden_dims[-1], hidden_dims)

    def forward(
        self,
        x_src: torch.Tensor,
        x_dst: torch.Tensor,
        edge_attr: torch.Tensor,
        graph: DeviceGraph,
    ) -> torch.Tensor:
        msg = self.GenCastMLP_0(
            [(x_src, graph.gather_senders), (x_dst, graph.gather_receivers), (edge_attr, None)]
        )
        agg = graph.aggregate(msg * self.scale_factor)
        return self.GenCastMLP_1(torch.cat([x_dst, agg], dim=-1))


class FourierEmbedding(nn.Module):
    """Sinusoidal embedding of a scalar conditioning value (32 frequencies,
    base period 16) + 2-layer SiLU MLP."""

    NUM_FREQUENCIES = 32
    BASE_PERIOD = 16

    def __init__(self, output_dim: int):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(2 * self.NUM_FREQUENCIES, output_dim)
        self.TorchLinear_1 = TorchLinear(output_dim, output_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        # t: [..., 1], f32 (the noise level): the MLP computes in f32 on
        # weights of any dtype
        n = self.NUM_FREQUENCIES
        steps = torch.arange(n, dtype=torch.float32, device=t.device)
        log_period = torch.log(torch.tensor(float(self.BASE_PERIOD)))
        freqs = torch.exp(-log_period * steps / n)
        args = t * freqs
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.TorchLinear_1(F.silu(self.TorchLinear_0(emb)))


class ConditionalLayerNorm(nn.Module):
    """LayerNorm (no affine, eps 1e-5), then x * Linear_s(cond) + Linear_b(cond)."""

    def __init__(self, features_dim: int, cond_dim: int):
        super().__init__()
        self.features_dim = features_dim
        self.TorchLinear_0 = TorchLinear(cond_dim, features_dim)
        self.TorchLinear_1 = TorchLinear(cond_dim, features_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        # Under the bf16 policy (bf16 weights; x f32 from the gate's `wide`
        # add): normalised in f32 and rounded, then the f32 scale and bias,
        # rounded again, as the JAX package rounds them.
        dtype = self.TorchLinear_0.kernel.dtype
        scale = self.TorchLinear_0(cond)
        bias = self.TorchLinear_1(cond)
        if dtype == torch.bfloat16:
            x_norm = Bf16LayerNorm.apply(x, None, None, 1e-5)
        else:
            x_norm = F.layer_norm(x, (self.features_dim,), eps=1e-5)
        return (scale * x_norm + bias).to(dtype)


class GraphTransformerConv(nn.Module):
    """UniMP-style multi-head graph attention (PyG TransformerConv semantics).

    q_i = W_q x_i; k_j = W_k x_j + W_e e_ij; v_j = W_v x_j + W_e e_ij;
    alpha_ij = softmax over i's senders of q_i . k_j / sqrt(C);
    out_i = sum_j alpha_ij v_j, then the beta gate (GenCast always gates):
    out = b * W_skip x_i + (1 - b) * out, b = sigmoid(W_beta [skip, out, skip - out]).

    Without edge features, a graph with a cluster layout takes the clustered
    branch (K3a; its backward K3c when the graph is symmetric, as the k-hop
    mesh graph is, else K3b), and one with a band layout the banded branch
    (K4a/K4b when `band_flash`, K4b's dk/dv kernel in its symmetric role on
    a symmetric graph; else the plain banded attention); otherwise
    the segment-softmax branch. The linears are numbered as flax creates
    them: q, k, v, [edge], skip, beta.
    """

    def __init__(
        self,
        in_dim: int,
        out_channels: int,
        num_heads: int,
        concat: bool = True,
        use_edge_features: bool = True,
        edge_dim: Optional[int] = None,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.concat = concat
        self.use_edge_features = use_edge_features
        hc = num_heads * out_channels
        final_dim = hc if concat else out_channels
        linears = [TorchLinear(in_dim, hc) for _ in range(3)]
        if use_edge_features:
            linears.append(TorchLinear(edge_dim, hc, use_bias=False))
        linears.append(TorchLinear(in_dim, final_dim))
        linears.append(TorchLinear(3 * final_dim, 1, use_bias=False))
        for i, lin in enumerate(linears):
            self.add_module(f"TorchLinear_{i}", lin)
        edge = int(use_edge_features)
        self._skip = f"TorchLinear_{3 + edge}"
        self._beta = f"TorchLinear_{4 + edge}"

    def forward(
        self,
        x: torch.Tensor,  # [..., N, F]
        graph: DeviceGraph,
        edge_attr: Optional[torch.Tensor] = None,  # [..., E, Fe] or [E, Fe]
    ) -> torch.Tensor:
        h, c = self.num_heads, self.out_channels
        q = self.TorchLinear_0(x)
        k = self.TorchLinear_1(x)
        v = self.TorchLinear_2(x)
        use_edges = self.use_edge_features and edge_attr is not None

        if not use_edges and (graph.cluster_ids is not None or graph.band_masks is not None):
            q4, k4, v4 = (t.reshape(t.shape[:-1] + (h, c)).contiguous() for t in (q, k, v))
            if graph.cluster_ids is not None:
                out = clustered_flash_attention(
                    q4, k4, v4, graph.cluster_ids, graph.cluster_masks, graph.cluster_block,
                    symmetric=graph.cluster_symmetric, scatter_index=graph.cluster_scatter,
                )
            else:
                band = (q4, k4, v4, graph.band_masks, graph.band_block, graph.band_w)
                if graph.band_flash:
                    out = banded_flash_attention(*band, symmetric=graph.band_symmetric)
                else:
                    out = banded_graph_attention(*band)
            return self._combine(x, out.reshape(out.shape[:-2] + (h * c,)))

        q_e = graph.gather_receivers(q)
        k_e = graph.gather_senders(k)
        v_e = graph.gather_senders(v)
        if use_edges:
            e = self.TorchLinear_3(edge_attr)
            k_e = k_e + e
            v_e = v_e + e

        def heads(t):
            return t.reshape(t.shape[:-1] + (h, c))

        if q_e.dtype == torch.bfloat16:  # f32 products, the sum rounded
            logits = (heads(q_e).float() * heads(k_e).float()).sum(-1).to(q_e.dtype)
        else:
            logits = (heads(q_e) * heads(k_e)).sum(-1)
        logits = logits / float(c) ** 0.5  # [..., E, H]
        alpha = segment_softmax(logits, graph.receivers, graph.n_receivers, graph.receiver_csr)
        msg = heads(v_e) * alpha[..., None]
        msg = msg.reshape(msg.shape[:-2] + (h * c,))
        return self._combine(x, graph.aggregate(msg))

    def _combine(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        h, c = self.num_heads, self.out_channels
        if not self.concat:
            out = out.reshape(out.shape[:-1] + (h, c)).mean(-2)
        skip = getattr(self, self._skip)(x)
        gate_in = torch.cat([skip, out, skip - out], dim=-1)
        b = sigmoid(getattr(self, self._beta)(gate_in))
        if b.dtype == torch.bfloat16:  # the last add `wide`: the norm's input
            return (b * skip).float() + ((1.0 - b) * out).float()
        return b * skip + (1.0 - b) * out


class CondTransformerBlock(nn.Module):
    """TransformerConv + conditional layer norm + activation.

    The final processor block averages heads and skips the activation.
    """

    def __init__(
        self,
        in_dim: int,
        out_channels: int,
        num_heads: int,
        cond_dim: int,
        concat: bool = True,
        use_edge_features: bool = True,
        edge_dim: Optional[int] = None,
        activation: Optional[Callable] = silu,
    ):
        super().__init__()
        self.activation = activation
        self.GraphTransformerConv_0 = GraphTransformerConv(
            in_dim, out_channels, num_heads, concat, use_edge_features, edge_dim
        )
        final_dim = num_heads * out_channels if concat else out_channels
        self.ConditionalLayerNorm_0 = ConditionalLayerNorm(final_dim, cond_dim)

    def forward(
        self,
        x: torch.Tensor,
        graph: DeviceGraph,
        edge_attr: Optional[torch.Tensor],
        cond: torch.Tensor,
    ) -> torch.Tensor:
        x = self.GraphTransformerConv_0(x, graph, edge_attr)
        x = self.ConditionalLayerNorm_0(x, cond)
        return x if self.activation is None else self.activation(x)
