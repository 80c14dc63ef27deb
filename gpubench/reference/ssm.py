"""Plain PyTorch reference of the Mamba-2 language model (SSD, state-space
duality) [arXiv:2405.21060], float32, for the benchmark's check of
training. It imports nothing of the program.

The model, as the system under test defines it:

    x = embed[tokens] * s          s = sqrt(d_model) rounded to bfloat16
    for each layer:  x = x + mixer(rms_norm(x, norm1))
    loss = mean cross-entropy of rms_norm(x, final_norm) @ head
    head = embed^T where the configuration ties it, else lm_head

    mixer(u):  z, x, B, C = u Wz, u Wx, u WB, u WC
               dt = softplus(u Wdt + dt_bias);  A = -exp(A_log)
               x, B, C = silu(causal depthwise conv_k of each)
               y = SSD(x, dt, A, B, C) + D x          (per head)
               return rms_norm(y * silu(z), norm) Wo

Departures from the published model, all of them the system's own
definition: the embedding is scaled by s, the convolutions have no bias
and the residual stream is stored in the configuration's dtype. The SSD
is evaluated by chunks (the paper's listing 1): within a chunk the
masked (C B^T) o L product, across chunks the chunk states carried by a
masked decay matrix over the chunks, every cumulative log-decay summed
in float64.

Parameters are float32 tensors keyed by dotted path (``"layers.ssm.wz"``);
the stacked layer leaves carry the layer as their first dim.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def dims(cfg: Dict) -> Dict[str, int]:
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return {"d": d, "di": di, "h": di // s["head_dim"], "p": s["head_dim"],
            "n": s["state_dim"], "k": s["conv_kernel"],
            "L": cfg["num_layers"], "V": cfg["vocab_size"]}


def param_table(cfg: Dict) -> List[Dict]:
    """Every leaf: its path, shape, stored dtype, how it is drawn and its
    fan-in (the width a normal draw is scaled by 1/sqrt of)."""
    m = dims(cfg)
    d, di, h, n, k, L, V = (m[x] for x in "d di h n k L V".split())
    bf, f32 = "bfloat16", "float32"

    def leaf(path, shape, dtype=bf, init="normal", fan_in=None):
        return {"path": path, "shape": list(shape), "dtype": dtype,
                "init": init, "fan_in": fan_in}

    head = [] if cfg["tie_embeddings"] else [leaf("lm_head", (d, V),
                                                   fan_in=d)]
    return head + [
        leaf("embed", (V, d), fan_in=d),
        leaf("final_norm", (d,), f32, "ones"),
        leaf("layers.norm1", (L, d), f32, "ones"),
        leaf("layers.ssm.A_log", (L, h), f32, "a_log"),
        leaf("layers.ssm.D", (L, h), f32, "ones"),
        leaf("layers.ssm.conv_B", (L, k, n), fan_in=k),
        leaf("layers.ssm.conv_C", (L, k, n), fan_in=k),
        leaf("layers.ssm.conv_x", (L, k, di), fan_in=k),
        leaf("layers.ssm.dt_bias", (L, h), f32, "dt_bias"),
        leaf("layers.ssm.norm", (L, di), f32, "ones"),
        leaf("layers.ssm.wB", (L, d, n), fan_in=d),
        leaf("layers.ssm.wC", (L, d, n), fan_in=d),
        leaf("layers.ssm.wdt", (L, d, h), fan_in=d),
        leaf("layers.ssm.wo", (L, di, d), fan_in=di),
        leaf("layers.ssm.wx", (L, d, di), fan_in=d),
        leaf("layers.ssm.wz", (L, d, di), fan_in=d),
    ]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over the sequence, then silu.
    x (b, l, c), w (k, c): out[t] = sum_j w[j] x[t - k + 1 + j]."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.silu(F.conv1d(xp, w.t()[:, None], groups=c).transpose(1, 2))


def ssd(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """y (b, l, h, p) of h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, from a zero state; x (b, l, h, p), dt (b, l, h), A (h,),
    B and C (b, l, n); l a multiple of `chunk`."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    c, q = l // chunk, chunk
    x = x.reshape(b, c, q, h, p)
    dt = dt.reshape(b, c, q, h)
    B = B.reshape(b, c, q, n)
    C = C.reshape(b, c, q, n)
    cs = torch.cumsum((dt * A).double(), dim=2)             # (b,c,q,h)
    seg = (cs[:, :, :, None] - cs[:, :, None]).float()       # (b,c,i,j,h)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", C, B)
    xdt = x * dt[..., None]                                  # (b,c,j,h,p)
    y = torch.einsum("bcijh,bcjhp->bcihp", decay * scores[..., None], xdt)
    to_end = torch.exp((cs[:, :, -1:] - cs).float())         # (b,c,j,h)
    states = torch.einsum("bcjn,bcjhp->bchpn", B, xdt * to_end[..., None])
    # the state entering chunk i: sum over j < i of chunk j's state decayed
    # through chunks j+1..i-1
    total = torch.cumsum(cs[:, :, -1], dim=1)                # (b,c,h)
    before = total - cs[:, :, -1]
    carry = (before[:, :, None] - total[:, None]).float()    # (b,i,j,h)
    below = torch.ones(c, c, dtype=torch.bool, device=x.device).tril(-1)
    carry = torch.exp(carry.masked_fill(~below[:, :, None], float("-inf")))
    enter = torch.einsum("bijh,bjhpn->bihpn", carry, states)
    y = y + (torch.einsum("bcqn,bchpn->bcqhp", C, enter)
             * torch.exp(cs.float())[..., None])
    return y.reshape(b, l, h, p)


def mixer(g: Dict[str, torch.Tensor], u: torch.Tensor, cfg: Dict,
          mm: Matmul) -> torch.Tensor:
    """One layer's mixer; `g` holds the layer's ``layers.ssm.*`` leaves
    under their last name."""
    m = dims(cfg)
    b, l, _ = u.shape
    z = mm(u, g["wz"])
    x = causal_conv(mm(u, g["wx"]), g["conv_x"])
    B = causal_conv(mm(u, g["wB"]), g["conv_B"])
    C = causal_conv(mm(u, g["wC"]), g["conv_C"])
    dt = F.softplus(mm(u, g["wdt"]) + g["dt_bias"])
    A = -torch.exp(g["A_log"])
    xh = x.reshape(b, l, m["h"], m["p"])
    y = ssd(xh, dt, A, B, C, cfg["ssm"]["chunk_size"]) + xh * g["D"][:, None]
    y = rms_norm(y.reshape(b, l, -1) * F.silu(z), g["norm"], cfg["norm_eps"])
    return mm(y, g["wo"])


def embed_scale(cfg: Dict) -> float:
    """sqrt(d_model) rounded to bfloat16, as the system scales its
    embedding."""
    return float(torch.tensor(math.sqrt(cfg["d_model"]),
                              dtype=torch.bfloat16))


def loss_sum(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, cfg: Dict, mm: Matmul) -> torch.Tensor:
    """The summed cross-entropy of `tokens`' rows against `targets`."""
    x = F.embedding(tokens, P["embed"]) * embed_scale(cfg)
    # each stacked leaf unbound once: one backward node that stacks the
    # layers' gradients, not one whole-leaf scatter a layer
    layers = {k: v.unbind(0) for k, v in P.items()
              if k.startswith("layers.")}
    for i in range(cfg["num_layers"]):
        g = {k.split(".")[-1]: v[i] for k, v in layers.items()
             if k.startswith("layers.ssm.")}
        u = rms_norm(x, layers["layers.norm1"][i], cfg["norm_eps"])
        x = x + mixer(g, u, cfg, mm)
    h = rms_norm(x, P["final_norm"], cfg["norm_eps"])
    head = P["embed"].t() if cfg["tie_embeddings"] else P["lm_head"]
    logits = mm(h, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")
