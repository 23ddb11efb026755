"""Model facade: init / loss / prefill / decode / extend.

Counterpart of ``repro.models.model`` for the dense family (``qwen2-7b``,
``starcoder2-3b``, ``starcoder2-7b``, ``granite-34b``): the same parameter
tree (``emb``, ``final_norm``, ``stack`` stacked over periods, ``tail``),
shapes and dtypes, float32 parameters and the compute dtype of the config.
The other families (``moe``, ``ssm``, ``hybrid``, ``encdec``, ``vlm``) are
refused with ``NotImplementedError`` when the model is built (ROADMAP queue
A 8d): a refusal, not a fallback.  There is no mesh, so the reference's
``sharding.specs.constrain`` hints are nothing here.

Two things differ from the reference, both for a serving engine on a GPU:

  * **decode and extension calls run at a fixed shape.**  A call that
    carries ``k <= STEP_ROWS`` tokens per sequence is computed on
    ``STEP_ROWS`` rows (the extra rows are token 0 at the next positions,
    queries only: they never enter a cache, and their logits are dropped).
    Every matmul and reduction of a ``decode_step`` and of an
    ``extend_step`` then has the same shape, and a GPU library computes
    each row of a given shape the same way whatever the other rows hold, so
    a token's logits do not depend on how many tokens its call carried:
    greedy speculative decoding gives plain greedy decoding's tokens bit
    for bit.  (cuBLAS picks its algorithm by shape; at two shapes the same
    row can round differently.)  The real rows' arithmetic is the
    reference's;
  * ``init`` takes a ``torch.Generator`` and draws other numbers than JAX;
    parity tests convert the reference's parameters
    (``repro_torch.convert.model_params_from_numpy``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    apply_norm,
    chunked_cross_entropy,
    dtype_of,
    embed_tokens,
    lm_logits,
    make_embeddings,
    make_norm,
)

PyTree = Any

#: decode and extension calls of up to this many tokens per sequence run
#: at this many rows (see the module docstring)
STEP_ROWS = 8

PORTED_FAMILIES = ("dense",)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless this package runs ``cfg``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} is not ported to "
            f"repro_torch yet (ROADMAP queue A 8d); ported: "
            f"{PORTED_FAMILIES}")
    if cfg.first_dense_layers:
        tfm.check_kind(cfg, "dense_mlp")
    if cfg.encoder_layers:
        tfm.check_kind(cfg, "enc_attn")
    for kind in cfg.pattern:
        tfm.check_kind(cfg, kind)


class Model:
    """Functional model bound to a ModelConfig.  No method writes into the
    parameters or the caches it is given."""

    def __init__(self, cfg: ModelConfig):
        check_ported(cfg)
        self.cfg = cfg
        # the reference sums every matmul in float32; cuBLAS may otherwise
        # add a reduced-precision matmul's split-K partial sums in bfloat16
        # or float16 (a process-wide setting of torch)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator, device=None) -> PyTree:
        """Random parameters drawn from ``generator`` (on its device), on
        ``device`` (default: the GPU; an error without one)."""
        cfg = self.cfg
        dev = resolve_device(device)
        params: Dict[str, PyTree] = {
            "emb": make_embeddings(cfg, generator, device=dev),
            "final_norm": make_norm(cfg, device=dev),
        }
        np_ = cfg.num_periods()
        if np_:
            params["stack"] = {
                f"pos{j}": tfm.make_block(cfg, kind, generator, device=dev,
                                          lead=(np_,))
                for j, kind in enumerate(cfg.pattern)
            }
        tail = cfg.tail_kinds()
        if tail:
            params["tail"] = [tfm.make_block(cfg, kind, generator, device=dev)
                              for kind in tail]
        return params

    def abstract_params(self) -> PyTree:
        """The parameter tree's shapes and dtypes, as meta tensors."""
        return self.init(None, device="meta")

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    @staticmethod
    def _device(params: PyTree) -> torch.device:
        return params["emb"]["tok"].device

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Returns (x, positions): the text tokens (no prefix embeddings in
        the ported family)."""
        tokens = torch.as_tensor(batch["tokens"], device=self._device(params))
        b, s_text = tokens.shape
        pos = torch.arange(s_text, dtype=torch.int32,
                           device=tokens.device).expand(b, s_text)
        x = embed_tokens(params["emb"], tokens, self.cfg, positions=pos[0])
        return x, pos

    def _body(self, params, x, positions, caches=None,
              insert: Optional[int] = None):
        """stack -> tail -> final norm. Returns (x, caches')."""
        cfg = self.cfg
        new_caches: Dict[str, PyTree] = {}
        if "stack" in params:
            x, _, cs = tfm.stack_forward(
                params["stack"], x, cfg, positions=positions,
                caches=None if caches is None else caches["stack"],
                insert=insert)
            new_caches["stack"] = cs
        if "tail" in params:
            out_tail = []
            for i, (bp, kind) in enumerate(zip(params["tail"],
                                               cfg.tail_kinds())):
                c = None if caches is None else caches["tail"][i]
                x, _, nc = tfm.block_forward(bp, x, cfg, kind,
                                             positions=positions, cache=c,
                                             insert=insert)
                out_tail.append(nc)
            new_caches["tail"] = out_tail
        x = apply_norm(params["final_norm"], x, cfg)
        return x, (new_caches if caches is not None else None)

    # ------------------------------------------------------------------
    # loss (forward only: training is not ported yet, ROADMAP queue A 9)
    # ------------------------------------------------------------------

    def loss_fn(self, params: PyTree, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, positions = self._embed_inputs(params, batch)
        x, _ = self._body(params, x, positions)
        targets = torch.as_tensor(batch["targets"], device=x.device)
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=x.device) if mask is None else
                torch.as_tensor(mask, device=x.device).to(torch.float32))
        ce = chunked_cross_entropy(params["emb"], x, targets, mask, self.cfg)
        return ce, {"ce": ce, "loss": ce}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def init_caches(self, b: int, max_len: int, *, device=None) -> PyTree:
        """Empty caches on ``device`` (default: the GPU): ``stack`` a list
        with one cache tree per period, ``tail`` one cache per block."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = dtype_of(cfg)
        kv, hd = cfg.num_kv_heads, cfg.head_dim

        def one(kind: str) -> attn_mod.KVCache:
            if kind == "local_attn":
                return attn_mod.init_cache(b, min(cfg.local_window, max_len),
                                           kv, hd, dt, ring=True, device=dev)
            return attn_mod.init_cache(b, max_len, kv, hd, dt, device=dev)

        caches: Dict[str, PyTree] = {}
        if cfg.num_periods():
            caches["stack"] = [{f"pos{j}": one(kind)
                                for j, kind in enumerate(cfg.pattern)}
                               for _ in range(cfg.num_periods())]
        tail = cfg.tail_kinds()
        if tail:
            caches["tail"] = [one(k) for k in tail]
        return caches

    def prefill(self, params: PyTree, batch: Dict[str, Any],
                max_len: int) -> Tuple[torch.Tensor, PyTree]:
        """Process the prompt; returns (last-token logits [B, V], caches)."""
        x, positions = self._embed_inputs(params, batch)
        caches = self.init_caches(x.shape[0], max_len, device=x.device)
        x, caches = self._body(params, x, positions, caches=caches)
        logits = lm_logits(params["emb"], x[:, -1], self.cfg)
        return logits, caches

    def extend_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos0: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """Extend warm caches by K tokens in ONE forward (speculative-decode
        verification).  tokens: [B, K]; pos0: [B] absolute position of
        tokens[:, 0].  Returns (logits [B, K, V], caches').  The caches
        given are not written: rollback after a partial acceptance is the
        caller keeping them.  Runs on ``max(K, STEP_ROWS)`` rows."""
        cfg = self.cfg
        dev = self._device(params)
        tokens = torch.as_tensor(tokens, device=dev)
        pos0 = torch.as_tensor(pos0, device=dev)
        b, k = tokens.shape
        rows = max(k, STEP_ROWS)
        if rows > k:
            tokens = torch.cat([tokens, tokens.new_zeros((b, rows - k))], 1)
        positions = pos0.to(torch.int32)[:, None] + torch.arange(
            rows, dtype=torch.int32, device=dev)[None, :]
        x = embed_tokens(
            params["emb"], tokens, cfg,
            positions=None if cfg.use_rope else torch.clamp(
                positions, 0, cfg.max_position_actual() - 1))
        x, new_caches = self._body(params, x, positions, caches=caches,
                                   insert=k)
        logits = lm_logits(params["emb"], x, cfg)[:, :k]
        return logits, new_caches

    def decode_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence. tokens: [B, 1]; pos: [B] absolute position
        of that token. Returns (logits [B, V], caches').  For the ported
        kinds the reference's decode is the extension by one token, and it
        runs as one here, at the extension's shape."""
        logits, new_caches = self.extend_step(params, caches, tokens, pos)
        return logits[:, 0], new_caches
