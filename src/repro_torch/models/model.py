"""The decoder LM, in PyTorch (the port of ``repro.models.model``'s
``LanguageModel``): one implementation for every family of the reference.

  dense / audio     uniform block (attention + MLP)
  local_global      gemma3: units of ``local_ratio`` sliding-window
                    blocks and one global block; the local layers keep a
                    ring KV cache of ``window`` slots
  moe               uniform block (attention + MoE), and for deepseek an
                    unstacked dense layer 0 (``block0``) whose MLP is as
                    wide as the active experts together
  ssm               mamba2: uniform SSD mixer blocks
  hybrid            zamba2: SSD blocks, and one *shared* attention block
                    (one parameter set, a KV cache per invocation) after
                    every ``attn_every``-th layer
  vlm               llama-3.2-vision: units of ``cross_every - 1`` self
                    blocks, an anchor block and a cross-attention to the
                    image features (precomputed, a frontend stub)

Per-layer parameters are stacked over layers (or units), as the
reference stacks them for ``lax.scan``; the port's loops index the stack
(:func:`layer_params`).  The tree is the reference's::

    embed [padded_vocab, d]            final_norm/scale [d]
    (unembed [padded_vocab, d] unless tie_embeddings)
    blocks/ln1/scale [L, d]            blocks/attn/{wq,wk,wv,wo}
    blocks/ln2/scale [L, d]            blocks/mlp/{w_gate?,w_up,w_down}
                                       or blocks/moe/{router,experts/*,shared/*}
    blocks/{local{i},global}/...       (local_global, per unit)
    blocks/{self{i},anchor}/..., blocks/ln_cross, blocks/cross (vlm)
    blocks/ln/scale, blocks/ssm/*      (ssm, hybrid)
    (block0/{ln1,attn,ln2,mlp} for a moe model with first_layer_dense)
    (shared_attn/{pre,attn,mid,mlp} for hybrid)

Entry points: ``forward`` (logits, no caches), ``loss``, ``prefill``
(logits and the filled :class:`DecodeCache`) and ``decode_step`` (one
token against the dense caches).  The reference fills the caches by
replaying the forward; ``prefill`` here fills them in the forward's own
pass (the same code, so its logits are ``forward``'s bit for bit), one
attention and one SSD scan per layer.  On the card every self-attention
of the forward goes through the ``flash_attention`` kernel and every SSM
layer through ``ssd_scan``.  The COW-paged serving path lives in
:mod:`repro_torch.serving.engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import assign, constrain, take_last, write_prefix, write_token
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Axes,
    ParamBuilder,
    embed,
    init_embedding,
    init_mlp,
    init_rms_norm,
    mlp,
    rms_norm,
    stack_layer_params,
    torch_dtype,
    unembed,
)

Params = Dict[str, Any]
Finish = Callable[[str, torch.Tensor], torch.Tensor]


class DecodeCache(NamedTuple):
    """Decode-time state.  Unused fields are size-0 tensors.

    k/v:         [n_full_layers, B, S_max, KVH, hd]   full-attention caches
    k_loc/v_loc: [n_units, n_local, B, window, KVH, hd] ring caches (gemma)
    ssm_conv:    [L, B, 3, conv_ch]; ssm_state: [L, B, H, P, N] (float32)
    shared_k/v:  [n_invocations, B, S_max, KVH, hd]   zamba2 shared block
    img_feats:   [B, n_img, D] (vlm cross-attention source)
    position:    [B] current length (int32)
    """

    k: torch.Tensor
    v: torch.Tensor
    k_loc: torch.Tensor
    v_loc: torch.Tensor
    ssm_conv: torch.Tensor
    ssm_state: torch.Tensor
    shared_k: torch.Tensor
    shared_v: torch.Tensor
    img_feats: torch.Tensor
    position: torch.Tensor


@dataclasses.dataclass
class LanguageModel:
    cfg: ModelConfig

    def init(
        self,
        generator: torch.Generator,
        *,
        device: torch.device | str = "cuda",
        finish: Optional[Finish] = None,
    ) -> Params:
        """Draw the parameters from ``generator`` on ``device`` by the
        reference's law, leaf by leaf in the reference's order; ``finish``
        maps each leaf (``finish("blocks/attn/wq", value)``) as soon as it
        is drawn."""
        return self._build(generator, resolve_device(device), finish)[0]

    def param_specs(self) -> Dict[str, Tuple[int, ...]]:
        """Each leaf's path (``"blocks/attn/wq"``) and shape, with nothing
        allocated."""
        return self._build(None, torch.device("meta"), None)[1]

    def abstract_init(self) -> Tuple[Params, Axes]:
        """Shape-only parameters (``meta`` tensors of the parameter dtype)
        and their logical axes, the reference's ``abstract_init``
        (``model.py:121`` of the JAX package): nothing is drawn or
        allocated.  The stacked ``blocks`` leaves carry a leading
        ``"layers"`` axis."""
        params, _, axes = self._build(None, torch.device("meta"), None)
        return params, axes

    def _build(
        self, generator: Optional[torch.Generator], dev: torch.device, finish: Optional[Finish]
    ) -> Tuple[Params, Dict[str, Tuple[int, ...]], Axes]:
        cfg = self.cfg

        def scoped(prefix):
            if finish is None:
                return None
            return lambda path, value: finish(f"{prefix}/{path}", value)

        b = ParamBuilder(generator, cfg.param_dtype, device=dev, finish=finish)
        init_embedding(b, "embed", cfg.padded_vocab, cfg.d_model)
        init_rms_norm(b, "final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            b.param("unembed", (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))
        params, specs, axes = dict(b.params), dict(b.specs), dict(b.axes)
        parts = [("blocks", stack_layer_params(
            self._init_block, generator, self._n_scan, cfg.param_dtype, device=dev,
            finish=scoped("blocks"),
        ))]
        if cfg.family == "hybrid":
            bb = ParamBuilder(generator, cfg.param_dtype, device=dev, finish=scoped("shared_attn"))
            init_rms_norm(bb, "pre", cfg.d_model)
            attn_lib.init_attention(bb.scope("attn"), cfg)
            init_rms_norm(bb, "mid", cfg.d_model)
            init_mlp(bb, "mlp", cfg.d_model, cfg.d_ff, cfg.gated_mlp)
            parts.append(("shared_attn", bb))
        if self.has_block0:
            bb = ParamBuilder(generator, cfg.param_dtype, device=dev, finish=scoped("block0"))
            self._init_dense_block(bb, d_ff=self._dense_ff)
            parts.append(("block0", bb))
        for name, part in parts:
            params[name], axes[name] = part.params, part.axes
            specs.update({f"{name}/{k}": v for k, v in part.specs.items()})
        return params, specs, axes

    @property
    def has_block0(self) -> bool:
        """deepseek's layer 0: a dense block outside the stack."""
        return self.cfg.family == "moe" and self.cfg.first_layer_dense

    @property
    def _n_scan(self) -> int:
        cfg = self.cfg
        if cfg.family == "local_global":
            return cfg.n_layers // (cfg.local_ratio + 1)
        if cfg.family == "vlm":
            return cfg.n_layers // cfg.cross_every
        return cfg.n_layers - (1 if self.has_block0 else 0)

    @property
    def _dense_ff(self) -> int:
        # deepseek's dense layer-0 FFN width: match total MoE active width
        cfg = self.cfg
        e_ff = cfg.expert_d_ff or cfg.d_ff
        return e_ff * (cfg.top_k + cfg.n_shared_experts)

    def _init_dense_block(self, b, d_ff: Optional[int] = None) -> None:
        cfg = self.cfg
        init_rms_norm(b, "ln1", cfg.d_model)
        attn_lib.init_attention(b.scope("attn"), cfg)
        init_rms_norm(b, "ln2", cfg.d_model)
        init_mlp(b, "mlp", cfg.d_model, d_ff or cfg.d_ff, cfg.gated_mlp)

    def _init_block(self, b) -> None:
        cfg = self.cfg
        fam = cfg.family
        if fam in ("dense", "audio"):
            self._init_dense_block(b)
        elif fam == "local_global":
            for i in range(cfg.local_ratio):
                self._init_dense_block(b.scope(f"local{i}"))
            self._init_dense_block(b.scope("global"))
        elif fam == "moe":
            init_rms_norm(b, "ln1", cfg.d_model)
            attn_lib.init_attention(b.scope("attn"), cfg)
            init_rms_norm(b, "ln2", cfg.d_model)
            moe_lib.init_moe(b.scope("moe"), cfg)
        elif fam in ("ssm", "hybrid"):
            init_rms_norm(b, "ln", cfg.d_model)
            ssm_lib.init_ssm(b.scope("ssm"), cfg)
        elif fam == "vlm":
            for i in range(cfg.cross_every - 1):
                self._init_dense_block(b.scope(f"self{i}"))
            self._init_dense_block(b.scope("anchor"))
            init_rms_norm(b, "ln_cross", cfg.d_model)
            attn_lib.init_attention(b.scope("cross"), cfg, cross=True)
        else:
            raise ValueError(fam)

    # ------------------------------------------------------------------
    # training forward, loss and prefill
    # ------------------------------------------------------------------
    def forward(
        self, params: Params, tokens: torch.Tensor, img_feats: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """tokens [B, S] (and, vlm, img_feats [B, n_img, D]) -> logits
        [B, S, padded_vocab] (float32), causal over the whole sequence, no
        caches."""
        logits = self._logits(params, self._run_blocks(params, tokens, img_feats, None))
        return constrain(logits, ("act_batch", None, "act_vocab"))

    def loss(
        self,
        params: Params,
        tokens: torch.Tensor,
        labels: torch.Tensor,
        img_feats: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy over the labels >= 0, and the
        accuracy of the argmax there.  Differentiable: ``loss.backward()``
        takes the gradient of every parameter the forward reads, through
        the ``flash_attention`` and ``ssd_scan`` backward kernels on the
        card, as the reference's ``jax.value_and_grad(lm.loss)`` does
        through its plain attention and scan.  With ``cfg.remat`` each
        layer's activations are recomputed in the backward
        (:meth:`_run_blocks`)."""
        logits = self.forward(params, tokens, img_feats)
        mask = labels >= 0
        safe = labels.clamp(min=0).long()
        if isinstance(logits, DTensor):
            # Vocab-parallel: pick the label's logit shard by shard; a hit is
            # the label's logit at the row's max (argmax up to ties).
            picked = take_last(logits, safe)
            hit = picked >= logits.amax(dim=-1)
        else:
            picked = logits.gather(-1, safe[..., None])[..., 0]
            hit = logits.argmax(dim=-1) == safe
        nll = torch.logsumexp(logits, dim=-1) - picked
        denom = mask.sum().clamp(min=1)
        loss = torch.where(mask, nll, 0.0).sum() / denom
        acc = (mask & hit).sum() / denom
        return loss, {"loss": loss, "accuracy": acc, "tokens": denom}

    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,
        max_len: int,
        img_feats: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> Tuple[torch.Tensor, DecodeCache]:
        """Process a prompt [B, S]; returns (logits [B, S, V], the decode
        cache of ``max_len`` positions filled through S).  One pass: the
        forward's, which writes each layer's K/V and SSM state into the
        cache as it goes; its logits equal ``forward``'s bit for bit.
        ``cache``, if given, is the zeroed cache to fill (a sharded one,
        in a cell on a mesh), else ``init_cache``'s."""
        b, s = tokens.shape
        if cache is None:
            cache = self.init_cache(b, max_len, img_feats, device=tokens.device)
        logits = self._logits(params, self._run_blocks(params, tokens, img_feats, cache))
        return logits, cache._replace(position=torch.full_like(cache.position, s))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.norm_eps)
        return unembed(params.get("unembed", params["embed"]), x)

    def _run_blocks(
        self,
        params: Params,
        tokens: torch.Tensor,
        img_feats: Optional[torch.Tensor],
        fill: Optional[DecodeCache],
    ) -> torch.Tensor:
        """The layer stack over the embedded tokens; with ``fill``, each
        layer's K (rotated) and V, ring slots and SSM state are written
        into that cache in place.  With ``cfg.remat``, while autograd
        records and no cache is filled, each layer runs under one
        ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
        as the reference wraps its scanned layer body in
        ``jax.checkpoint``: its activations are dropped after the forward
        and recomputed in the backward (the forward kernels launch twice
        a layer)."""
        cfg = self.cfg
        fam = cfg.family
        eps = cfg.norm_eps
        b, s = tokens.shape
        # Pin the residual stream to batch sharding, as the reference does.
        x = constrain(embed(params["embed"], tokens, torch_dtype(cfg.dtype)), ("act_batch", None, None))
        remat = cfg.remat and fill is None and torch.is_grad_enabled()

        def layer(fn, h):
            """One layer ``fn(h) -> h``, under a checkpoint when ``remat``."""
            if remat:
                return torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False)
            return fn(h)

        def attend(p, h, k_c=None, v_c=None, window=0, norm="ln1"):
            out, k, v = attn_lib.attention_train(
                p["attn"], rms_norm(h, p[norm]["scale"], eps), cfg, window=window
            )
            if k_c is not None:
                write_prefix(k_c, k)
                write_prefix(v_c, v)
            return h + out, k, v

        def dense_block(p, h, k_c=None, v_c=None, window=0):
            h, k, v = attend(p, h, k_c, v_c, window)
            return h + feed_forward(p, rms_norm(h, p["ln2"]["scale"], eps), cfg), k, v

        def ssm_block(p, h, layer):
            out, c = ssm_lib.ssm_layer(p["ssm"], rms_norm(h, p["ln"]["scale"], eps), cfg)
            if fill is not None:
                assign(fill.ssm_conv, (layer,), c.conv)
                assign(fill.ssm_state, (layer,), c.state)
            return h + out

        def slot(leaf, *idx):
            return None if fill is None else getattr(fill, leaf)[idx]

        def shared_block(sp, h, inv):
            h, _, _ = attend(sp, h, slot("shared_k", inv), slot("shared_v", inv), norm="pre")
            return h + mlp(sp["mlp"], rms_norm(h, sp["mid"]["scale"], eps), cfg.act)

        def local_block(p, h, u, i):
            h, k, v = dense_block(p, h, window=cfg.window)
            if fill is not None:
                assign(fill.k_loc, (u, i), _to_ring(k, s, cfg.window))
                assign(fill.v_loc, (u, i), _to_ring(v, s, cfg.window))
            return h

        def cross_block(p, h):
            return h + attn_lib.cross_attention(
                p["cross"], rms_norm(h, p["ln_cross"]["scale"], eps), img_feats.to(h.dtype), cfg
            )

        blocks = params["blocks"]
        if fam in ("dense", "audio", "moe"):
            for i, p in enumerate(iter_layers(params, cfg)):
                x = layer(lambda h, p=p, i=i: dense_block(p, h, slot("k", i), slot("v", i))[0], x)
        elif fam == "ssm":
            for i in range(cfg.n_layers):
                x = layer(lambda h, i=i: ssm_block(layer_params(blocks, i), h, i), x)
        elif fam == "hybrid":
            sp = params["shared_attn"]
            every = cfg.attn_every
            for i in range(cfg.n_layers):
                x = layer(lambda h, i=i: ssm_block(layer_params(blocks, i), h, i), x)
                if i % every == every - 1:
                    x = layer(lambda h, inv=i // every: shared_block(sp, h, inv), x)
        elif fam == "local_global":
            for u in range(self._n_scan):
                pu = layer_params(blocks, u)
                for i in range(cfg.local_ratio):
                    x = layer(lambda h, p=pu[f"local{i}"], u=u, i=i: local_block(p, h, u, i), x)
                x = layer(lambda h, p=pu["global"], u=u: dense_block(p, h, slot("k", u), slot("v", u))[0], x)
        elif fam == "vlm":
            if img_feats is None:
                raise ValueError("the vlm family needs img_feats [B, n_img, D]")
            n = cfg.cross_every
            for u in range(self._n_scan):
                pu = layer_params(blocks, u)
                for i, name in enumerate([f"self{j}" for j in range(n - 1)] + ["anchor"]):
                    x = layer(lambda h, p=pu[name], j=u * n + i: dense_block(p, h, slot("k", j), slot("v", j))[0], x)
                x = layer(lambda h, p=pu: cross_block(p, h), x)
        else:
            raise ValueError(fam)
        return x

    # ------------------------------------------------------------------
    # decode caches and the decode step
    # ------------------------------------------------------------------
    def init_cache(
        self,
        batch: int,
        max_len: int,
        img_feats: Optional[torch.Tensor] = None,
        *,
        device: torch.device | str = "cuda",
    ) -> DecodeCache:
        """Zeroed caches for ``batch`` rows of up to ``max_len`` positions,
        the reference's shapes and dtypes, on ``device`` (``meta``: shapes
        alone, nothing allocated)."""
        cfg = self.cfg
        dev = resolve_device(device, allow_meta=True)
        dt = torch_dtype(cfg.dtype)
        kvh, hd = cfg.n_kv_heads, cfg.hd

        def e(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        k = v = k_loc = v_loc = ssm_conv = ssm_state = shared_k = shared_v = e(0)
        fam = cfg.family
        if fam in ("dense", "audio", "moe", "vlm"):
            k, v = e(cfg.n_layers, batch, max_len, kvh, hd), e(cfg.n_layers, batch, max_len, kvh, hd)
        if fam == "local_global":
            units = self._n_scan
            k, v = e(units, batch, max_len, kvh, hd), e(units, batch, max_len, kvh, hd)
            k_loc = e(units, cfg.local_ratio, batch, cfg.window, kvh, hd)
            v_loc = e(units, cfg.local_ratio, batch, cfg.window, kvh, hd)
        if fam in ("ssm", "hybrid"):
            one = ssm_lib.init_ssm_cache(cfg, batch, dt, dev)
            ssm_conv = one.conv.expand(cfg.n_layers, *one.conv.shape).contiguous()
            ssm_state = one.state.expand(cfg.n_layers, *one.state.shape).contiguous()
        if fam == "hybrid":
            n_inv = cfg.n_layers // cfg.attn_every
            shared_k, shared_v = e(n_inv, batch, max_len, kvh, hd), e(n_inv, batch, max_len, kvh, hd)
        img = img_feats if img_feats is not None else e(batch, 0, cfg.d_model)
        return DecodeCache(
            k=k, v=v, k_loc=k_loc, v_loc=v_loc, ssm_conv=ssm_conv, ssm_state=ssm_state,
            shared_k=shared_k, shared_v=shared_v, img_feats=img,
            position=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    def decode_step(
        self, params: Params, tokens: torch.Tensor, cache: DecodeCache
    ) -> Tuple[torch.Tensor, DecodeCache]:
        """tokens [B, 1] at ``cache.position`` -> (logits [B, V], the cache
        one position on).  The cache passed in is consumed: the new
        token's K/V, ring slots and SSM states are written into its
        tensors in place (no copy of the caches a step), so read the old
        state before the call if it is needed again."""
        cfg = self.cfg
        fam = cfg.family
        eps = cfg.norm_eps
        b = tokens.shape[0]
        pos = cache.position  # [B]
        rows, at = torch.arange(b, device=tokens.device), pos.long()
        x = constrain(embed(params["embed"], tokens, torch_dtype(cfg.dtype)), ("act_batch", None, None))

        def attn_step(p, h, k_c, v_c, window=0, norm="ln1"):
            out, k_new, v_new = attn_lib.attention_decode(
                p["attn"], rms_norm(h, p[norm]["scale"], eps), k_c, v_c, pos, cfg, window=window
            )
            write_token(k_c, at, k_new[:, 0], rows)
            write_token(v_c, at, v_new[:, 0], rows)
            return h + out

        def dense_step(p, h, k_c, v_c):
            h = attn_step(p, h, k_c, v_c)
            return h + feed_forward(p, rms_norm(h, p["ln2"]["scale"], eps), cfg)

        def ssm_step(p, h, layer):
            out, c = ssm_lib.ssm_decode(
                p["ssm"], rms_norm(h, p["ln"]["scale"], eps),
                ssm_lib.SSMCache(cache.ssm_conv[layer], cache.ssm_state[layer]), cfg,
            )
            assign(cache.ssm_conv, (layer,), c.conv)
            assign(cache.ssm_state, (layer,), c.state)
            return h + out

        blocks = params["blocks"]
        if fam in ("dense", "audio", "moe"):
            for i, p in enumerate(iter_layers(params, cfg)):
                x = dense_step(p, x, cache.k[i], cache.v[i])
        elif fam == "ssm":
            for i in range(cfg.n_layers):
                x = ssm_step(layer_params(blocks, i), x, i)
        elif fam == "hybrid":
            sp = params["shared_attn"]
            every = cfg.attn_every
            for i in range(cfg.n_layers):
                x = ssm_step(layer_params(blocks, i), x, i)
                if i % every == every - 1:
                    inv = i // every
                    x = attn_step(sp, x, cache.shared_k[inv], cache.shared_v[inv], norm="pre")
                    x = x + mlp(sp["mlp"], rms_norm(x, sp["mid"]["scale"], eps), cfg.act)
        elif fam == "local_global":
            for u in range(self._n_scan):
                pu = layer_params(blocks, u)
                for i in range(cfg.local_ratio):
                    x = self._ring_step(pu[f"local{i}"], x, cache.k_loc[u, i], cache.v_loc[u, i], pos)
                x = dense_step(pu["global"], x, cache.k[u], cache.v[u])
        elif fam == "vlm":
            n = cfg.cross_every
            feats = cache.img_feats
            for u in range(self._n_scan):
                pu = layer_params(blocks, u)
                for i, name in enumerate([f"self{j}" for j in range(n - 1)] + ["anchor"]):
                    x = dense_step(pu[name], x, cache.k[u * n + i], cache.v[u * n + i])
                x = x + attn_lib.cross_attention(
                    pu["cross"], rms_norm(x, pu["ln_cross"]["scale"], eps), feats.to(x.dtype), cfg
                )
        else:
            raise ValueError(fam)
        logits = self._logits(params, x)[:, 0]
        return logits, cache._replace(position=cache.position + 1)

    def _ring_step(self, p, h, k_c, v_c, pos):
        """A sliding-window layer's decode step against its ring cache of
        ``window`` slots [B, w, KVH, hd]; slot ``j`` holds the position
        ``pos - 1 - ((pos - 1 - j) mod w)``, masked where that is negative
        or, after a wrap, too old."""
        cfg = self.cfg
        w = cfg.window
        hn = rms_norm(h, p["ln1"]["scale"], cfg.norm_eps)
        slot = torch.arange(w, dtype=torch.int32, device=h.device)[None, :]
        age = (pos[:, None] - 1 - slot) % w  # distance of each slot
        k_pos = pos[:, None] - 1 - age
        q, k_new, v_new = attn_lib.qkv_proj(p["attn"], hn, cfg)
        q = attn_lib.apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = attn_lib.apply_rope(k_new, pos[:, None], cfg.rope_theta)
        scores = attn_lib._grouped_scores(q, k_c).float()
        ok = (k_pos >= 0) & (k_pos < pos[:, None]) & (pos[:, None] - k_pos < w)
        self_s = attn_lib._grouped_scores(q, k_new).float()
        scores = torch.where(ok[:, None, None, None, :], scores, attn_lib.NEG_INF)
        allp = torch.softmax(torch.cat([scores, self_s], dim=-1), dim=-1).to(h.dtype)
        out = attn_lib._grouped_out(allp[..., :w], v_c) + attn_lib._grouped_out(allp[..., w:], v_new)
        h = h + attn_lib.out_proj(p["attn"], out)
        h = h + mlp(p["mlp"], rms_norm(h, p["ln2"]["scale"], cfg.norm_eps), cfg.act)
        rows, at = torch.arange(h.shape[0], device=h.device), (pos % w).long()
        write_token(k_c, at, k_new[:, 0], rows)
        write_token(v_c, at, v_new[:, 0], rows)
        return h


def _to_ring(k_new: torch.Tensor, s: int, w: int) -> torch.Tensor:
    """The ring layout of a local layer's K or V [B, s, KVH, hd] after s
    tokens: slot ``j`` holds the last position ``p < s`` with ``p mod w ==
    j``.  As the reference lays it out, a slot no position has reached yet
    (``s < w``) holds position ``s - 1`` (decode masks it)."""
    slots = torch.arange(w, device=k_new.device)
    abs_pos = slots + ((s - 1 - slots) // w) * w if s >= w else slots
    return k_new[:, abs_pos.clamp(0, s - 1)]


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's slice of the stacked ``blocks`` tree (views)."""
    return {
        k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
        for k, v in blocks.items()
    }


def iter_layers(params: Params, cfg: ModelConfig) -> Iterator[Params]:
    """Each layer's parameters in depth order for the uniform families
    (dense, audio, moe): ``block0`` first where the model has one, then
    the stack."""
    if "block0" in params:
        yield params["block0"]
    n = cfg.n_layers - (1 if "block0" in params else 0)
    for layer in range(n):
        yield layer_params(params["blocks"], layer)


def feed_forward(p: Params, hn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN on its normed input: the MoE where the layer has one,
    else the MLP."""
    if "moe" in p:
        return moe_lib.moe_layer(p["moe"], hn, cfg)
    return mlp(p["mlp"], hn, cfg.act)
