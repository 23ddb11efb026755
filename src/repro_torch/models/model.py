"""Model facade: init / loss / prefill / decode / extend.

Counterpart of ``repro.models.model`` for every family: ``dense``
(``qwen2-7b``, ``starcoder2-3b``, ``starcoder2-7b``, ``granite-34b``),
``moe`` (``deepseek-moe-16b``, ``moonshot-v1-16b-a3b``), ``ssm``
(``mamba2-130m``), ``hybrid`` (``recurrentgemma-9b``), ``encdec``
(``whisper-base``: an encoder over stub frame embeddings, ``batch["frames"]``
[B, T, D], and ``cross`` decoder blocks) and ``vlm`` (``phi-3-vision-4.2b``:
stub patch embeddings, ``batch["prefix_embeds"]`` [B, P, D], before the
text).  The same parameter tree (``emb``, ``final_norm``, ``pre`` (leading
dense layers), ``stack`` stacked over periods, ``tail``, ``enc_stack`` and
``enc_norm``), shapes and dtypes, float32 parameters and the compute dtype
of the config.  There is no mesh, so the reference's
``sharding.specs.constrain`` hints are nothing here.  ``loss_fn`` is
differentiable (``train/train_step.py`` takes its gradients with
``torch.autograd``).

Three things differ from the reference, each for a serving engine on a
GPU:

  * **decode and extension calls run at a fixed shape.**  A call that
    carries ``k <= STEP_ROWS`` tokens per sequence is computed on
    ``STEP_ROWS`` rows (the extra rows are token 0 at the next positions,
    pad rows: queries only for attention, never in a cache, never
    dispatched to an expert, never stepped through a recurrence; their
    logits are dropped).  Every matmul and reduction of a ``decode_step``
    and of an ``extend_step`` then has the same shape, and a GPU library
    computes each row of a given shape the same way whatever the other rows
    hold, so a token's logits do not depend on how many tokens its call
    carried: greedy speculative decoding gives plain greedy decoding's
    tokens bit for bit.  (cuBLAS picks its algorithm by shape; at two
    shapes the same row can round differently.)  The recurrent kinds
    (``ssm``, ``rglru``) step an extension's tokens one at a time with the
    decode arithmetic, so an extension of K tokens is K decodes, not the
    reference's chunked or associative form (which sums in another order);
    the prefill keeps the reference's forms;
  * **a ``local_attn`` ring holds ``STEP_ROWS`` more positions than the
    window**, so an extension into a ring that has wrapped computes what
    its tokens' decodes compute, and a ring's prefill attends over the
    prompt itself (the reference's cached calls lose keys in both cases;
    ``init_caches``, ``transformer.block_forward``);
  * a prefill or an extension whose tokens reach past a ``cross`` block's
    self-cache (``min(decoder_max_len, max_len)`` positions: whisper's
    learned decoder positions) raises ``ValueError``; the reference's
    scatter drops such a write silently, and on the GPU it would be an
    out-of-range index (ROADMAP queue C);
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
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    apply_norm,
    chunked_cross_entropy,
    dtype_of,
    embed_tokens,
    lm_logits,
    make_embeddings,
    make_norm,
    sinusoidal_positions,
)

PyTree = Any

#: decode and extension calls of up to this many tokens per sequence run
#: at this many rows (see the module docstring)
STEP_ROWS = 8


def _cross_cache_len(caches: PyTree) -> int:
    """Positions of the first ``cross`` block's self-cache in ``caches``."""
    if isinstance(caches, dict):
        if "self" in caches:
            return caches["self"].k.shape[1]
        todo = list(caches.values())
    elif isinstance(caches, list):
        todo = caches
    else:
        todo = []
    for c in todo:
        n = _cross_cache_len(c)
        if n:
            return n
    return 0


class Model:
    """Functional model bound to a ModelConfig.  No method writes into the
    parameters or the caches it is given."""

    def __init__(self, cfg: ModelConfig):
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
        if cfg.first_dense_layers:   # leading dense layers (deepseek)
            params["pre"] = [tfm.make_block(cfg, "dense_mlp", generator,
                                            device=dev)
                             for _ in range(cfg.first_dense_layers)]
        np_ = cfg.num_periods()
        if np_:
            params["stack"] = {
                f"pos{j}": tfm.make_block(cfg, kind, generator, device=dev,
                                          lead=(np_,))
                for j, kind in enumerate(self._decoder_pattern())
            }
        tail = cfg.tail_kinds()
        if tail:
            params["tail"] = [tfm.make_block(cfg, self._map_kind(kind),
                                             generator, device=dev)
                              for kind in tail]
        if cfg.encoder_layers:   # whisper's encoder
            params["enc_stack"] = {"pos0": tfm.make_block(
                cfg, "enc_attn", generator, device=dev,
                lead=(cfg.encoder_layers,))}
            params["enc_norm"] = make_norm(cfg, device=dev)
        return params

    def abstract_params(self) -> PyTree:
        """The parameter tree's shapes and dtypes, as meta tensors."""
        return self.init(None, device="meta")

    def _map_kind(self, kind: str) -> str:
        return "cross" if (self.cfg.encoder_layers and kind == "attn") else kind

    def _decoder_pattern(self) -> Tuple[str, ...]:
        return tuple(self._map_kind(k) for k in self.cfg.pattern)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    @staticmethod
    def _device(params: PyTree) -> torch.device:
        return params["emb"]["tok"].device

    def _encode(self, params: PyTree, frames) -> torch.Tensor:
        """Whisper encoder over stub frame embeddings [B, T, D]."""
        cfg = self.cfg
        dev = self._device(params)
        x = torch.as_tensor(frames, device=dev).to(dtype_of(cfg))
        t = x.shape[1]
        x = x + sinusoidal_positions(t, cfg.d_model, dev).to(x.dtype)[None]
        pos = torch.arange(t, dtype=torch.int32, device=dev).expand(
            x.shape[0], t)
        x, _, _ = tfm.stack_forward(params["enc_stack"], x, cfg,
                                    positions=pos, kinds=("enc_attn",))
        return apply_norm(params["enc_norm"], x, cfg)

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor, int]:
        """Returns (x, positions, n_prefix): a ``vlm``'s prefix embeddings
        then its text, positions over both; the text alone otherwise."""
        cfg = self.cfg
        dev = self._device(params)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        b, s_text = tokens.shape
        if cfg.frontend == "patch":
            prefix = torch.as_tensor(batch["prefix_embeds"], device=dev).to(
                dtype_of(cfg))
            npre = prefix.shape[1]
            pos = torch.arange(npre + s_text, dtype=torch.int32,
                               device=dev).expand(b, npre + s_text)
            x_tok = embed_tokens(params["emb"], tokens, cfg,
                                 positions=pos[0, npre:])
            return torch.cat([prefix, x_tok], dim=1), pos, npre
        pos = torch.arange(s_text, dtype=torch.int32,
                           device=dev).expand(b, s_text)
        x = embed_tokens(params["emb"], tokens, cfg, positions=pos[0])
        return x, pos, 0

    def _memory(self, params, batch) -> Optional[torch.Tensor]:
        return (self._encode(params, batch["frames"])
                if self.cfg.encoder_layers else None)

    def _body(self, params, x, positions, caches=None,
              insert: Optional[int] = None,
              memory: Optional[torch.Tensor] = None):
        """pre -> stack -> tail -> final norm. Returns (x, aux, caches')."""
        cfg = self.cfg
        aux_all: Dict[str, torch.Tensor] = {}
        new_caches: Dict[str, PyTree] = {}

        def blocks(x, name, kinds):   # the unstacked blocks, in turn
            out = []
            for i, (bp, kind) in enumerate(zip(params[name], kinds)):
                c = None if caches is None else caches[name][i]
                x, aux, nc = tfm.block_forward(bp, x, cfg, kind,
                                               positions=positions, cache=c,
                                               insert=insert, memory=memory)
                out.append(nc)
                aux_all.update(aux)
            new_caches[name] = out
            return x

        if "pre" in params:
            x = blocks(x, "pre", ("dense_mlp",) * cfg.first_dense_layers)
        if "stack" in params:
            x, aux, cs = tfm.stack_forward(
                params["stack"], x, cfg, positions=positions,
                caches=None if caches is None else caches["stack"],
                memory=memory, kinds=self._decoder_pattern(), insert=insert)
            tfm.add_aux(aux_all, aux)
            new_caches["stack"] = cs
        if "tail" in params:
            x = blocks(x, "tail",
                       tuple(self._map_kind(k) for k in cfg.tail_kinds()))
        x = apply_norm(params["final_norm"], x, cfg)
        return x, aux_all, (new_caches if caches is not None else None)

    # ------------------------------------------------------------------
    # training loss
    # ------------------------------------------------------------------

    def loss_fn(self, params: PyTree, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch ``{"tokens", "targets"}`` (+
        ``"loss_mask"``, ``"frames"`` for ``encdec``, ``"prefix_embeds"``
        for ``vlm``; the prefix is dropped before the head)."""
        memory = self._memory(params, batch)
        x, positions, npre = self._embed_inputs(params, batch)
        x, aux, _ = self._body(params, x, positions, memory=memory)
        if npre:
            x = x[:, npre:]
        targets = torch.as_tensor(batch["targets"], device=x.device)
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=x.device) if mask is None else
                torch.as_tensor(mask, device=x.device).to(torch.float32))
        ce = chunked_cross_entropy(params["emb"], x, targets, mask, self.cfg)
        loss = ce
        if "moe_lb_loss" in aux:
            loss = loss + 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        metrics = {"ce": ce, "loss": loss}
        for k2 in ("moe_lb_loss", "moe_z_loss"):
            if k2 in aux:
                metrics[k2] = aux[k2]
        return loss, metrics

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def init_caches(self, b: int, max_len: int, enc_len: int = 0, *,
                    device=None) -> PyTree:
        """Empty caches on ``device`` (default: the GPU): ``pre`` and
        ``tail`` one cache per block, ``stack`` a list with one cache tree
        per period.  A ``local_attn`` ring holds ``local_window +
        STEP_ROWS`` positions, the reference's ``local_window``: an
        extension inserts its K tokens before its rows attend, and in a ring
        of the window alone the K-th would overwrite a key the first still
        needs once the ring has wrapped (ROADMAP queue C 30).  A ``cross``
        block's cache is ``{"self": min(decoder_max_len, max_len) positions,
        "mem_k", "mem_v": [b, enc_len, kv, hd]}``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = dtype_of(cfg)
        kv, hd = cfg.num_kv_heads, cfg.head_dim

        def one(kind: str) -> PyTree:
            if kind == "local_attn":
                return attn_mod.init_cache(
                    b, min(cfg.local_window + STEP_ROWS, max_len), kv, hd, dt,
                    ring=True, device=dev)
            if kind == "ssm":
                return ssm_mod.init_ssm_cache(cfg, b, dt, device=dev)
            if kind == "rglru":
                return rglru_mod.init_rglru_cache(cfg, b, dt, device=dev)
            if kind == "cross":
                mem = (b, enc_len, kv, hd)
                return {
                    "self": attn_mod.init_cache(
                        b, min(cfg.decoder_max_len, max_len), kv, hd, dt,
                        device=dev),
                    "mem_k": torch.zeros(mem, dtype=dt, device=dev),
                    "mem_v": torch.zeros(mem, dtype=dt, device=dev),
                }
            return attn_mod.init_cache(b, max_len, kv, hd, dt, device=dev)

        caches: Dict[str, PyTree] = {}
        if cfg.first_dense_layers:
            caches["pre"] = [one("dense_mlp")
                             for _ in range(cfg.first_dense_layers)]
        if cfg.num_periods():
            caches["stack"] = [{f"pos{j}": one(kind)
                                for j, kind in enumerate(
                                    self._decoder_pattern())}
                               for _ in range(cfg.num_periods())]
        tail = cfg.tail_kinds()
        if tail:
            caches["tail"] = [one(self._map_kind(k)) for k in tail]
        return caches

    def _check_cross_positions(self, last: int, cache_len: int) -> None:
        """Refuse tokens at ``last`` or before it that a ``cross`` block's
        self-cache of ``cache_len`` positions cannot hold."""
        if last >= cache_len:
            raise ValueError(
                f"{self.cfg.name}: a token at position {last} does not fit "
                f"the decoder's self-cache of {cache_len} positions "
                f"(min(decoder_max_len={self.cfg.decoder_max_len}, "
                f"max_len)); the reference drops such a write silently")

    def prefill(self, params: PyTree, batch: Dict[str, Any],
                max_len: int) -> Tuple[torch.Tensor, PyTree]:
        """Process the prompt (and ``frames`` / ``prefix_embeds``); returns
        (last-token logits [B, V], caches).  A ``vlm``'s decode and
        extension continue at position ``n_prefix + s_text``."""
        cfg = self.cfg
        if cfg.encoder_layers:
            self._check_cross_positions(
                tuple(batch["tokens"].shape)[1] - 1,
                min(cfg.decoder_max_len, max_len))
        memory = self._memory(params, batch)
        x, positions, _ = self._embed_inputs(params, batch)
        caches = self.init_caches(
            x.shape[0], max_len, 0 if memory is None else memory.shape[1],
            device=x.device)
        x, _, caches = self._body(params, x, positions, caches=caches,
                                  memory=memory)
        logits = lm_logits(params["emb"], x[:, -1], cfg)
        return logits, caches

    def extend_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos0: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """Extend warm caches by K tokens in ONE forward (speculative-decode
        verification).  tokens: [B, K]; pos0: [B] absolute position of
        tokens[:, 0].  Returns (logits [B, K, V], caches').  The caches
        given are not written: rollback after a partial acceptance is the
        caller keeping them.  Runs on ``max(K, STEP_ROWS)`` rows; the
        recurrent caches returned are those after the K tokens.  A
        ``cross`` block reads the encoder's memory from its cache."""
        cfg = self.cfg
        dev = self._device(params)
        tokens = torch.as_tensor(tokens, device=dev)
        pos0 = torch.as_tensor(pos0, device=dev)
        b, k = tokens.shape
        if cfg.encoder_layers:   # one host read of pos0 per call
            self._check_cross_positions(
                int(pos0.max()) + k - 1, _cross_cache_len(caches))
        rows = max(k, STEP_ROWS)
        if rows > k:
            tokens = torch.cat([tokens, tokens.new_zeros((b, rows - k))], 1)
        positions = pos0.to(torch.int32)[:, None] + torch.arange(
            rows, dtype=torch.int32, device=dev)[None, :]
        x = embed_tokens(
            params["emb"], tokens, cfg,
            positions=None if cfg.use_rope else torch.clamp(
                positions, 0, cfg.max_position_actual() - 1))
        x, _, new_caches = self._body(params, x, positions, caches=caches,
                                      insert=k)
        logits = lm_logits(params["emb"], x, cfg)[:, :k]
        return logits, new_caches

    def decode_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence. tokens: [B, 1]; pos: [B] absolute position
        of that token. Returns (logits [B, V], caches').  The extension by
        one token, at the extension's shape: for attention the reference's
        decode is that extension, and the recurrent kinds take one decode
        step either way."""
        logits, new_caches = self.extend_step(params, caches, tokens, pos)
        return logits[:, 0], new_caches
