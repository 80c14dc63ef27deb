"""LanguageModel: the public model API the trainer and the server drive.

The port of ``repro/models/model.py``:

  train_loss(params, batch)               -- mean next-token cross-entropy
  prefill(params, batch, max_len)         -- (logits of the last token, caches)
  decode_step(params, token, caches, pos) -- one token against the caches

Parameters are a :class:`~repro_torch.models.layers.ParamTree` in the JAX
package's layout (``init``, or :func:`repro_torch.models.convert.
params_from_jax`); caches are dicts of tensors that prefill and decode
update in place. Every family is ported: ``dense``, ``moe`` (capacity
dispatch, with expert parallelism where ``options.mesh`` has a ``"model"``
axis), ``ssm`` (Mamba-2), ``hybrid`` (RecurrentGemma), ``encdec``
(Whisper: an encoder over stub frame embeddings ``batch["frames"]`` (b,
enc_seq, d_model), a decoder that cross-attends to it) and ``vlm``
(LLaVA: stub patch embeddings ``batch["patches"]`` (b, patches, d_model)
projected and put before the text). ``train_loss`` trains every family;
on the card the recurrent families' scans run their CUDA kernels forward
and backward (``torch.autograd.Function``s whose backwards are kernels too).

As in the reference, Whisper's encoder layers are causal and roped (they
are the ``"attn"`` block), a decode step embeds the sinusoid of position
0, and frames wider than the weights (the trainer's float32 stubs) carry
the encoder, its output and the cross-attention keys and values in the
wider dtype (``ROADMAP.md`` Queue 3).

float32 runs on the card assume full-precision matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default); the
entry points set it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    ParamSpec,
    ParamTree,
    abstract_from_specs,
    axes_from_specs,
    init_from_specs,
    layer_norm,
    layers_from_specs,
    promoted_einsum,
    sinusoidal_embedding,
    tag_layer,
    tree_map,
)
from repro_torch.models.xent import linear_xent

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    # dense | blockwise | blockwise_unrolled | flash
    attn_impl: str = "dense"
    scan_layers: bool = True
    remat: str = "none"               # none | full | dots (train mode)
    # fused linear + cross-entropy (models/xent.py): the (b, s, V) logits
    # are not kept for the backward
    fused_xent: bool = True
    dtype: torch.dtype = torch.bfloat16
    # MoE blocks: the ProcessMesh whose "model" axis shards the experts
    # (None, or no such axis: the dense capacity dispatch on this rank)
    mesh: Optional[Any] = None
    # MoE expert parallelism: the over-decomposition degree Q of the
    # dispatch and combine all-to-alls (core/a2a_scan.py), Q capacity
    # slices; 1 = the monolithic pair. Read only where EP runs.
    moe_a2a_chunks: int = 1


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


class LanguageModel:
    def __init__(self, cfg: ModelConfig, options: Optional[ModelOptions] = None):
        if cfg.family not in FAMILIES:
            raise tfm._not_ported(f"model family {cfg.family!r}")
        self.cfg = cfg
        self.opt = options or ModelOptions()

    # ------------------------------------------------------------------ specs
    def param_specs(self) -> PyTree:
        """Every leaf carries layer provenance (``ParamSpec.layer``): depth 0
        for the embedding and the frontend projections, ``1..N`` through
        the stack, ``N + 1`` on the head, so the grad-sync schedule knows
        which gradients complete first in the backward. The encoder's
        backward runs after the decoder stack's (its gradients gather the
        cross-attention of every decoder layer), so an encoder-decoder's
        encoder layers take depths ``1..enc_layers``, its final norm
        ``enc_layers + 1``, and the decoder stack starts above them, as
        in the reference."""
        cfg, dt = self.cfg, self.opt.dtype
        enc_depth = cfg.encdec.enc_layers + 1 if cfg.family == "encdec" else 0
        stack0 = enc_depth + 1
        head_depth = stack0 + cfg.num_layers
        specs: Dict[str, Any] = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), dt,
                               scale=cfg.d_model ** -0.5, layer=0),
            "layers": tfm.stack_specs(cfg, self.opt.scan_layers, dt,
                                      depth0=stack0),
        }
        specs.update(tag_layer(tfm._norm_specs(cfg, "final_norm"),
                               head_depth))
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                         ("embed", "vocab"), dt,
                                         layer=head_depth)
        if cfg.family == "encdec":
            specs["encoder"] = [
                tag_layer(tfm.layer_specs(self._enc_cfg(), "attn", dt), 1 + i)
                for i in range(cfg.encdec.enc_layers)]
            specs.update(tag_layer(tfm._norm_specs(cfg, "enc_norm"),
                                   enc_depth))
            specs["audio_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                            ("embed", None), dt, layer=0)
        if cfg.family == "vlm":
            # stub projection of precomputed patch embeddings
            specs["vision_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                             ("embed", None), dt, layer=0)
        return specs

    def _enc_cfg(self) -> ModelConfig:
        return dataclasses.replace(self.cfg,
                                   num_layers=self.cfg.encdec.enc_layers)

    def init(self, seed: int = 0, device="cuda") -> ParamTree:
        return ParamTree(init_from_specs(self.param_specs(), seed, device))

    def abstract_params(self) -> PyTree:
        """Meta-device stand-ins of :meth:`init`'s params (shapes and
        dtypes, no storage)."""
        return abstract_from_specs(self.param_specs())

    def param_axes(self) -> PyTree:
        """Logical-axes tree matching :meth:`init`'s params (each leaf's
        ``ParamSpec.axes``; a scanned stack's leaves lead with
        ``"layers"``), which ``sharding.rules.resolve_pspec`` places."""
        return axes_from_specs(self.param_specs())

    def param_layers(self) -> PyTree:
        """Layer-provenance tree matching :meth:`init`'s params: per-leaf
        forward depth, consumed by the reverse-topological grad-sync bucket
        schedule (``core/overlap.py``)."""
        return layers_from_specs(self.param_specs())

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor, start: int = 0,
               total: Optional[int] = None) -> torch.Tensor:
        """The scaled embedding of `tokens`, rows ``start..start+s-1`` of
        a sequence of `total` (default s) rows: a tensor-parallel rank
        embeds its block of the rows."""
        # F.embedding: a gather whose backward is deterministic on the card
        x = torch.nn.functional.embedding(tokens, params["embed"])
        return self._embed_rows(x, start, total)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        x = tfm._norm(params, x, self.cfg, "final_norm")
        if self.cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = x @ params["lm_head"]
        return logits.float()

    def _encode(self, params, frames: torch.Tensor, tp=None
                ) -> torch.Tensor:
        """Whisper's encoder over stub frame embeddings (b, enc_seq,
        d_model): the projection plus the sinusoid, the encoder layers
        (block "attn" of this family: LayerNorm, causal roped
        self-attention through ``attn_impl``, as in the reference; not
        rematerialized) and the final LayerNorm. It runs in the wider of
        the frames' and the weights' dtypes, each product promoting its
        weights as ``jnp.result_type`` would. With `tp` the encoder runs
        under the cut on this rank's rows of the frames (and returns
        those rows): the dense attention of ``layer_apply``'s cut."""
        cfg = self.cfg
        t = frames.shape[1]
        start, total, impl = 0, t, self.opt.attn_impl
        if tp is not None:
            frames, impl = tp.rows(frames), "dense"
            start, t = tp.index * (t // tp.n), t // tp.n
        x = (promoted_einsum("bsd,de->bse", frames, params["audio_proj"])
             + _sinusoid_rows(start, t, total, cfg.d_model, frames))
        b = x.shape[0]
        pos = (None if tp is not None
               else torch.arange(t, device=x.device).expand(b, t))
        enc_cfg = self._enc_cfg()
        for p_l in params["encoder"]:
            p_l = tree_map(lambda w: w.to(torch.promote_types(w.dtype,
                                                              x.dtype)), p_l)
            x, _, _ = tfm.layer_apply(p_l, x, enc_cfg, "attn", pos, "train",
                                      None, None, impl, tp=tp)
        return layer_norm(x, params["enc_norm"], params["enc_norm_b"],
                          cfg.norm_eps)

    def _encode_cut(self, params, frames: torch.Tensor, tp) -> torch.Tensor:
        """:meth:`_encode` under the cut with every rank's rows gathered:
        the whole (b, enc_seq, d_model) output on every rank. Frames whose
        rows do not divide over the cut's ranks (Whisper's 1500 over 16)
        are padded at the end with zero rows to the next multiple and the
        pad rows dropped after the gather: the encoder is causal, so no
        real row reads a pad row."""
        t = frames.shape[1]
        pad = -t % tp.n
        if pad:
            frames = torch.nn.functional.pad(frames, (0, 0, 0, pad))
        return tp.gather_seq(self._encode(params, frames, tp))[:, :t]

    def _prepend_frontend(self, params, x: torch.Tensor,
                          batch: Dict) -> torch.Tensor:
        """The VLM's projected patches (cast to the text's dtype) before the
        text; other families' x unchanged."""
        if self.cfg.family != "vlm":
            return x
        patches = promoted_einsum("bsd,de->bse", batch["patches"],
                                  params["vision_proj"])
        return torch.cat([patches.to(x.dtype), x], dim=1)

    # ---------------------------------------------------------------- forward
    def _forward(self, params, batch: Dict, mode: str, caches=None,
                 pos=None) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
        """Hidden states (before the final norm), the caches and the MoE aux
        loss summed over the layers (None without MoE blocks). `mode` is
        "train" (full sequence, no cache), "prefill" or "decode". Train
        and prefill take the frontend inputs of their family (``frames``,
        ``patches``); decode takes none."""
        tokens = batch["token"] if mode == "decode" else batch["tokens"]
        x = self._embed(params, tokens)
        enc_out = None
        if mode != "decode":
            x = self._prepend_frontend(params, x, batch)
            if self.cfg.family == "encdec":
                enc_out = self._encode(params, batch["frames"])
        b, s, _ = x.shape
        if mode == "decode":
            # scalar pos: every slot at the same position (wave scheduler);
            # (b,) pos: per-slot positions (continuous batching)
            positions = None  # decode_attention builds them from pos
        else:
            positions = torch.arange(s, device=x.device).expand(b, s)
        return tfm.stack_apply(params["layers"], x, self.cfg, positions, mode,
                               caches, pos, self.opt.attn_impl,
                               remat=self.opt.remat, mesh=self.opt.mesh,
                               enc_out=enc_out,
                               a2a_chunks=self.opt.moe_a2a_chunks)

    # ------------------------------------------------------------ entry points
    def train_loss(self, params, batch: Dict, tp=None, stream=None
                   ) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` ((b, s) int64), a 0-d float32 tensor. Fused
        (``options.fused_xent``): :func:`~repro_torch.models.xent.
        linear_xent` on the final-normed activations; otherwise the f32
        logits' log-softmax. The MoE family adds its aux load-balancing
        loss, as the reference does; the VLM's patch positions are not in
        the loss.

        With `tp` (a :class:`~repro_torch.sharding.tp.TPCut`; every
        family), `params` holds this rank's blocks with the embedding and
        head whole (the train step gathers them over the vocab), `batch`
        the model line's rows, and the result is this rank's share of the
        loss: the ranks' results times ``1/tp`` sum to the mean
        (:meth:`_train_loss_tp`). `stream` (with `tp` only) is
        ``stack_apply``'s hook: ``params["layers"]`` then holds this
        rank's blocks of the stack and ``stream(i, p_l)`` makes layer
        `i`'s TP blocks inside the layer's remat region (the TP step's
        per-layer gathers, ``TPPlan.layer_view``)."""
        if tp is not None:
            return self._train_loss_tp(params, batch, tp, stream)
        if stream is not None:
            raise ValueError("train_loss takes `stream` with `tp` only "
                             "(ZeRO-3 streams through train_loss_streamed)")
        x, _, aux = self._forward(params, batch, "train")
        if self.cfg.family == "vlm":
            x = x[:, self.cfg.num_vision_patches:]
        targets = batch["targets"]
        if self.opt.fused_xent:
            x = tfm._norm(params, x, self.cfg, "final_norm")
            w = (params["embed"].t() if self.cfg.tie_embeddings
                 else params["lm_head"])
            loss = linear_xent(x, w, targets)
        else:
            loss = self._xent(params, x, targets)
        return loss if aux is None else loss + aux.to(loss.dtype)

    def _train_loss_tp(self, params, batch: Dict, tp, stream=None
                       ) -> torch.Tensor:
        """The tensor-parallel loss: this rank's block of the sequence
        (sequence parallelism between the blocks) is embedded from the
        whole table, run through the stack's cut
        (:func:`~repro_torch.models.transformer.stack_apply` with `tp`),
        and scored against the whole head (a tied head is the same
        table), the logits never leaving the rank's rows: the mean over
        them, which is the rank's share of the mean over every row.

        Whisper adds the sinusoid's rows of the rank's block, and runs
        its encoder under the cut on the rank's rows of the frames; the
        encoder's output is all-gathered once for the decoder's
        cross-attention (the backward reduce-scatters). The VLM puts its
        patches before the text first, so a rank's block may hold
        patches, text or both; only the text rows are scored, their sum
        over the rank divided by ``b * text / tp``, so that the ranks'
        shares still make the JAX loss, the mean over the text.

        The MoE family routes each rank's rows under expert parallelism
        (:func:`~repro_torch.models.moe.moe_apply_tp`, its all-to-alls
        chunked ``moe_a2a_chunks`` ways); the aux loss is the same on
        every rank (its expert loads are averaged over the mesh), so each
        rank adds it whole: times ``1/tp``, a model line counts it once."""
        cfg = self.cfg
        tokens, targets = batch["tokens"], batch["targets"]
        enc_out, denom = None, None
        if cfg.family == "vlm":
            x, targets, skip = self._vlm_rows(params, batch, tp)
            denom = targets.shape[0] * tokens.shape[1] / tp.n
        else:
            tokens, targets = tp.rows(tokens), tp.rows(targets)
            x = self._embed(params, tokens, tp.index * tokens.shape[1],
                            batch["tokens"].shape[1])
        if cfg.family == "encdec":
            enc_out = self._encode_cut(params, batch["frames"], tp)
        x, _, aux = tfm.stack_apply(params["layers"], x, cfg, None, "train",
                                    None, None, self.opt.attn_impl,
                                    remat=self.opt.remat, stream=stream,
                                    enc_out=enc_out, tp=tp,
                                    a2a_chunks=self.opt.moe_a2a_chunks)
        if cfg.family == "vlm":
            x = x[:, skip:]
        if not self.opt.fused_xent:
            loss = self._xent(params, x, targets, denom)
        else:
            x = tfm._norm(params, x, cfg, "final_norm")
            w = (params["embed"].t() if cfg.tie_embeddings
                 else params["lm_head"])
            loss = linear_xent(x, w, targets, denom)
        return loss if aux is None else loss + aux.to(loss.dtype)

    def _vlm_rows(self, params, batch: Dict, tp
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """This rank's rows [lo, hi) of the VLM's sequence, the projected
        patches then the text: (their embeddings, the targets of the text
        rows, the number of patch rows before them). Either part may be
        empty; it still takes part in the graph."""
        n_p = self.cfg.num_vision_patches
        tokens = batch["tokens"]
        total = n_p + tokens.shape[1]
        if total % tp.n:
            raise ValueError(f"sequence {total} ({n_p} patches and the "
                             f"text) does not divide over the {tp.n} ranks "
                             f"of {tp.axis!r}")
        rows = total // tp.n
        lo, hi = tp.index * rows, (tp.index + 1) * rows
        t0, t1 = max(lo, n_p) - n_p, max(hi, n_p) - n_p
        x = self._embed(params, tokens[:, t0:t1])
        patches = promoted_einsum("bsd,de->bse",
                                  batch["patches"][:, lo:min(hi, n_p)],
                                  params["vision_proj"])
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x, batch["targets"][:, t0:t1], patches.shape[1]

    def _xent(self, params, x, targets, denom: Optional[float] = None
              ) -> torch.Tensor:
        """The unfused loss: log-softmax of the f32 logits; their mean, or
        their sum over `denom`."""
        logp = torch.log_softmax(self._unembed(params, x), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        if denom is None:
            return -torch.mean(ll)
        return -torch.sum(ll) / denom

    def train_loss_streamed(self, pflat, batch: Dict, stream) -> torch.Tensor:
        """Streaming-ZeRO-3 train loss: `pflat` holds this rank's per-bucket
        flat parameter SHARDS and `stream` is the :class:`~repro_torch.
        core.overlap.FsdpStream` gather/free schedule (started on them).

        Each layer all-gathers exactly its own bucket inside its remat
        region: the gather is issued just before the consuming compute, the
        gathered buffer dies after the layer's forward, and the backward
        recomputes layers in reverse order — regathering buckets
        last-backward-first, each gather's backward reduce-scattering the
        bucket's gradient. The embed and head buckets gather un-checkpointed
        at their point of use: the embedding's backward never needs the
        table (it scatters the cotangent), and the head weight's saved copy
        spans only the forward/backward boundary, where it IS the working
        set. A tied embedding gathers depth 0 a second time for the head,
        as the reference does: its two gradients are reduce-scattered apart
        and summed, so on more than one rank its gradient differs from
        gathering all's in the last bits (``ROADMAP.md`` Queue 3). Uses the
        unfused log-softmax loss, as the reference does.

        Gradients land in `stream` (:meth:`~repro_torch.core.overlap.
        FsdpStream.finish`), reduce-scattered: the SUM over the DP shards.
        Scanned stacks raise ``ValueError`` (per-layer gathers need visible
        layer boundaries), as does the reference, and so does the
        encoder-decoder (its encoder's output is read by every decoder
        layer)."""
        cfg = self.cfg
        if self.opt.scan_layers:
            raise ValueError(
                "train_loss_streamed needs the unrolled stack "
                "(scan_layers=False): per-layer gather placement requires "
                "visible layer boundaries")
        if cfg.family == "encdec":
            raise ValueError(
                "train_loss_streamed supports decoder-only stacks (the "
                "encoder's cross-attention KV is consumed by every decoder "
                "layer, so its buckets have no single free point)")
        head_depth = 1 + cfg.num_layers
        head_depths = (head_depth, 0) if cfg.tie_embeddings else (head_depth,)

        p0 = stream.materialize(pflat, 0)
        x = self._embed(p0, batch["tokens"])
        x = self._prepend_frontend(p0, x, batch)
        del p0                      # the table dies here, not at the end
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        def layer_stream(i, flat):
            return stream.materialize(flat, 1 + i)["layers"][i]

        stack_flat = [stream.flat_at(pflat, 1 + i)
                      for i in range(cfg.num_layers)]
        x, _, aux = tfm.stack_apply(stack_flat, x, cfg, positions, "train",
                                    None, None, self.opt.attn_impl,
                                    remat=self.opt.remat, mesh=self.opt.mesh,
                                    stream=layer_stream,
                                    a2a_chunks=self.opt.moe_a2a_chunks)
        if cfg.family == "vlm":
            x = x[:, cfg.num_vision_patches:]
        loss = self._xent(stream.materialize(pflat, *head_depths), x,
                          batch["targets"])
        return loss if aux is None else loss + aux.to(loss.dtype)

    def prefill(self, params, batch: Dict, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """`max_len` sizes the ring caches for the decode phase that follows;
        without it the cache holds exactly the prompt and the FIRST generated
        token evicts prompt token 0. The VLM's caches also hold its patch
        positions, which come first: decode positions continue from
        ``num_vision_patches + prompt length``. Returns ((b, 1, vocab) f32
        logits of the last token, caches)."""
        b, s = batch["tokens"].shape
        if self.cfg.family == "vlm":
            s += self.cfg.num_vision_patches
        caches = self.init_caches(b, max(s, max_len or 0),
                                  params["embed"].device)
        x, caches, _ = self._forward(params, batch, "prefill", caches=caches)
        return self._unembed(params, x[:, -1:]), caches

    def decode_step(self, params, token: torch.Tensor, caches, pos
                    ) -> Tuple[torch.Tensor, Any]:
        """token (b, 1); pos a scalar or a per-slot (b,) tensor. Returns
        ((b, 1, vocab) f32 logits, caches updated in place)."""
        x, caches, _ = self._forward(params, {"token": token}, "decode",
                                     caches=caches, pos=pos)
        return self._unembed(params, x), caches

    # ------------------------------------------------- entry points, the cut
    def prefill_cut(self, params, batch: Dict, caches, cut
                    ) -> Tuple[torch.Tensor, Any]:
        """:meth:`prefill` under the serving cut (`cut`, a
        :class:`~repro_torch.sharding.tp.ServeCut`): `params` holds this
        rank's blocks with every dim the "model" axis does not place
        whole (``launch/steps.py`` ``ServePlan.compute``), `batch` this
        data replica's rows with the whole sequence, `caches` this rank's
        empty cache blocks in the prefill placement, filled in place.

        The embedding is looked up in the rank's block of the vocabulary
        (zero rows for the other ids) and the partial sums leave through
        a reduce-scatter onto the rank's rows of the sequence (every
        other id's row is exactly 0, so the sum is the lookup); the VLM's
        patches are added by the first rank of the line, Whisper's
        sinusoid after the sum. The stack runs under the cut
        (:func:`~repro_torch.models.transformer.stack_apply` with
        `cut`), the last row of the sequence is gathered from the rank
        that holds it, and the head gives this rank's block of the
        vocabulary. Returns ((b, 1, V or V/tp) f32 logits, caches)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        e = self._lookup(params["embed"], tokens, cut)
        enc_out = None
        if cfg.family == "vlm":
            patches = promoted_einsum("bsd,de->bse", batch["patches"],
                                      params["vision_proj"]).to(e.dtype)
            if cut.vocab and cut.index:     # added once to the sum
                patches = torch.zeros_like(patches)
            x = cut.rows_of_sum(torch.cat([patches, e * _scale(cfg, e)],
                                          dim=1), cut.vocab)
        else:
            x = cut.rows_of_sum(e, cut.vocab)
            s = tokens.shape[1]
            x = self._embed_rows(x, cut.index * (s // cut.n), s)
        if cfg.family == "encdec":
            enc_out = self._encode_cut(params, batch["frames"], cut)
        x, caches, _ = tfm.stack_apply(params["layers"], x, cfg, None,
                                       "prefill", caches, None,
                                       self.opt.attn_impl, enc_out=enc_out,
                                       tp=cut,
                                       a2a_chunks=self.opt.moe_a2a_chunks)
        last = cut.gather_seq(x[:, -1:])[:, -1:]
        return self._unembed(params, last), caches

    def decode_step_cut(self, params, token: torch.Tensor, caches, pos, cut
                        ) -> Tuple[torch.Tensor, Any]:
        """:meth:`decode_step` under the serving cut: `params` as in
        :meth:`prefill_cut`, `token` (b, 1) this replica's rows, `caches`
        this rank's blocks (the rings' slot blocks as they rest, the
        other leaves with every dim the "model" axis does not place
        whole), updated in place, `pos` a scalar. Every block's output is
        all-reduced over the "model" axis, so each rank of a line holds
        the whole (b, 1, d) between blocks. Returns ((b, 1, V or V/tp)
        f32 logits, caches)."""
        e = self._lookup(params["embed"], token, cut)
        if cut.vocab:
            e = cut.all_reduce(e)
        x = self._embed_rows(e, 0, 1)
        x, caches, _ = tfm.stack_apply(params["layers"], x, self.cfg, None,
                                       "decode", caches, pos,
                                       self.opt.attn_impl, tp=cut,
                                       a2a_chunks=self.opt.moe_a2a_chunks)
        return self._unembed(params, x), caches

    def _embed_rows(self, e: torch.Tensor, start: int = 0,
                    total: Optional[int] = None) -> torch.Tensor:
        """:meth:`_embed` after the lookup: looked-up rows `e`, rows
        ``start..`` of a sequence of `total` (default its own length).
        Whisper adds those rows of the sinusoid (a decode step adds row 0
        whatever its position, as the reference does); the scale is
        rounded to the activation dtype first, as in the JAX package."""
        if self.cfg.family == "encdec":
            e = e + _sinusoid_rows(start, e.shape[1], total,
                                   self.cfg.d_model, e)
        return e * _scale(self.cfg, e)

    @staticmethod
    def _lookup(table: torch.Tensor, tokens: torch.Tensor, cut
                ) -> torch.Tensor:
        """The embedding rows of `tokens` from `table`, or, where the cut
        places the vocabulary, from this rank's block of it: a zero row
        for every id outside the block."""
        if not cut.vocab:
            return torch.nn.functional.embedding(tokens, table)
        vl = table.shape[0]
        idx = tokens - cut.index * vl
        inside = (idx >= 0) & (idx < vl)
        e = torch.nn.functional.embedding(idx.clamp(0, vl - 1), table)
        return e * inside[..., None].to(e.dtype)

    # ----------------------------------------------------------------- caches
    def cache_specs(self, batch: int, max_len: int) -> PyTree:
        return tfm.stack_cache_specs(self.cfg, batch, max_len,
                                     self.opt.scan_layers, self.opt.dtype)

    def init_caches(self, batch: int, max_len: int, device="cuda") -> PyTree:
        return init_from_specs(self.cache_specs(batch, max_len), 0, device)


def _scale(cfg: ModelConfig, like: torch.Tensor) -> torch.Tensor:
    """sqrt(d_model) rounded to `like`'s dtype first, as in the JAX
    package (11.3125 in bf16 at d_model 128)."""
    return torch.tensor(cfg.d_model ** 0.5, dtype=like.dtype,
                        device=like.device)


def _sinusoid_rows(start: int, rows: int, total: Optional[int], dim: int,
                   like: torch.Tensor) -> torch.Tensor:
    """Rows ``start..start+rows-1`` of the (total, dim) sinusoid (total
    default ``rows``), in `like`'s dtype and on its device, with a
    leading batch dim: the rows one rank of a sequence split adds."""
    total = rows if total is None else total
    emb = sinusoidal_embedding(total, dim, like.device)
    return emb[start:start + rows].to(like.dtype)[None]


# ------------------------------------------------------------------- factories
def build_model(cfg: ModelConfig, options: Optional[ModelOptions] = None
                ) -> LanguageModel:
    return LanguageModel(cfg, options)


def init_params(cfg: ModelConfig, seed: int = 0,
                options: Optional[ModelOptions] = None,
                device="cuda") -> ParamTree:
    return build_model(cfg, options).init(seed, device)


def abstract_params(cfg: ModelConfig, options: Optional[ModelOptions] = None
                    ) -> PyTree:
    return build_model(cfg, options).abstract_params()


# ------------------------------------------------------------------ input specs
def input_specs(cfg: ModelConfig, shape, options: Optional[ModelOptions] = None
                ) -> Dict[str, Any]:
    """Meta-device stand-ins (+ logical axes) of a cell's inputs, for a
    :class:`~repro_torch.config.shapes.ShapeConfig` `shape`.

    train/prefill: {'tokens', 'targets'?, 'patches'?, 'frames'?}
    decode:        {'token', 'caches', 'pos'}

    As the reference's, with the port's integer dtype (int64: tokens,
    the rings' positions) where the reference has int32."""
    model = build_model(cfg, options)
    b, s = shape.global_batch, shape.seq_len
    i64 = torch.int64

    def meta(*dims, dtype=i64):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.num_vision_patches if cfg.family == "vlm" else 0)
        specs["tokens"] = meta(b, s_text)
        axes["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            specs["targets"] = meta(b, s_text)
            axes["targets"] = ("batch", "seq")
        if cfg.family == "vlm":
            specs["patches"] = meta(b, cfg.num_vision_patches, cfg.d_model,
                                    dtype=torch.bfloat16)
            axes["patches"] = ("batch", None, None)
        if cfg.family == "encdec":
            specs["frames"] = meta(b, cfg.encdec.enc_seq, cfg.d_model,
                                   dtype=torch.bfloat16)
            axes["frames"] = ("batch", None, None)
    else:  # decode
        specs["token"] = meta(b, 1)
        axes["token"] = ("batch", None)
        cspecs = model.cache_specs(b, s)
        specs["caches"] = abstract_from_specs(cspecs)
        axes["caches"] = axes_from_specs(cspecs)
        specs["pos"] = meta(dtype=torch.int32)
        axes["pos"] = ()
    return {"specs": specs, "axes": axes}
