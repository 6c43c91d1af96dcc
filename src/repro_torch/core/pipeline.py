"""Layer-wise one-shot compression loop (port of
``repro.core.pipeline``: all six families), with calibration
statistics from activation taps and per-linear policy from a
``core.plan.CompressionPlan``.

  for each transformer layer, in order:
    (1) forward the calibration set, streamed in ``CalibrationSpec``
        chunks, through the already-compressed prefix to the layer's
        inputs,
    (2) run the layer's real forward (``models.lm._layer_fwd``) under
        one ``tap_capture``: the ``linear()`` chokepoint reports every
        linear's exact input, reduced on the fly to ‖X‖₂ column norms
        and, for the linears whose resolved compressor's ``needs`` holds
        "hessian", to the X^T X Gram matrix, accumulated across chunks,
    (3) resolve every linear through the plan and compress it with the
        matched compressor at the rule's config (unmatched and ``skip``
        linears stay dense),
    (4) replace the weights and continue forward with the compressed
        layer's outputs (error propagation).

Statistics and compression are separable: ``collect_model_stats`` runs
ONE streaming pass over the uncompressed model (each layer's capture
forward is also the propagation) and returns a ``ModelTapStats``;
``compress_model(..., stats=...)`` compresses from it with no forwards.
The budget allocator (``core.allocator``) probes its per-layer CRs from
those statistics and hands both the concrete plan and the statistics
back, so allocate + compress costs one calibration pass; a plan that
``wants_allocation`` goes through it automatically.

Params hold one dict per layer (``params["layers"][l]``); weights are
stored (D_in, D_out) in the model and transposed to the paper's
(D_out, D_in) for the compressor and back. MoE experts, (E, D_in, D_out)
leaves, are compressed one expert at a time from that expert's own
tapped statistics (the tokens dispatched to it), and their
decompositions travel as a tuple, one per expert.

The hybrid family's shared transformer block (``params["shared_attn"]``,
outside the layer list) taps as ``shared.*`` on the layers where it
fires. Its statistics are taken, and it is compressed, once: at its
first firing layer, after that layer's ``mamba.*`` linears, into a copy
of ``params["shared_attn"]``, so every later invocation (and the
propagation through that layer) runs the compressed block. Its
decompositions are keyed at the firing layer under ``shared.*``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import plan as plan_lib
from repro_torch.core import scores as scores_lib
from repro_torch.core.compressor import LinearStats
from repro_torch.core.slab import SLaBConfig
from repro_torch.models import lm
from repro_torch.models.common import ArchConfig, positions_for, tap_capture


@dataclasses.dataclass
class CompressStats:
    layer: int
    name: str
    err_before: float   # ‖W diag(n)‖_F — the zero-approximation baseline
    err_after: float    # ‖(W - Ŵ) diag(n)‖_F with the same tapped norms
    cr: float           # measured compression ratio
    method: str = ""
    variant: str = ""   # packed-serving variant ("" = none)
    cr_requested: float = 0.0   # the CR the resolved plan rule asked for


@dataclasses.dataclass
class ModelTapStats:
    """Whole-model tap statistics from ONE streaming calibration pass,
    keyed ``(layer, path)``: norms (D_in,) (stacked (E, D_in) for MoE
    experts) and Hessians (D_in, D_in) / (E, D_in, D_in). ``n_forwards``
    counts the ``models.lm._layer_fwd`` calls consumed: ``n_layers *
    n_chunks`` for one pass."""

    norms: Dict[Tuple[int, str], torch.Tensor]
    hessians: Dict[Tuple[int, str], torch.Tensor]
    n_forwards: int = 0


def _get(d: dict, path: str):
    cur = d
    for k in path.split("."):
        if k not in cur:
            return None
        cur = cur[k]
    return cur


def _set(d: dict, path: str, val):
    ks = path.split(".")
    cur = d
    for k in ks[:-1]:
        cur = cur[k]
    cur[ks[-1]] = val


def _copy_tree(d):
    """Copy the dict structure (tensors are shared, not cloned)."""
    if isinstance(d, dict):
        return {k: _copy_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_copy_tree(v) for v in d]
    return d


def linear_paths(cfg: ArchConfig) -> List[str]:
    """Compressible linears inside one layer: 2-D, and the 3-D (E, D,
    F) expert leaves of the moe family, with its shared experts' 2-D
    linears when ``cfg.shared_ff`` is set. The Mamba block's ``in_b``,
    ``in_c`` and ``in_dt`` stay dense, as in the reference."""
    lm._check_family(cfg)
    if cfg.family in lm.SSM_FAMILIES:
        return ["mamba.in_z", "mamba.in_x", "mamba.out"]
    paths = ["attn.wq", "attn.wk", "attn.wv", "attn.wo"]
    if cfg.family == "moe":
        paths += ["moe.w_gate", "moe.w_up", "moe.w_down"]
        if cfg.shared_ff:
            paths += ["moe.shared.w_gate", "moe.shared.w_up",
                      "moe.shared.w_down"]
        return paths
    if cfg.act == "swiglu":
        return paths + ["mlp.w_gate", "mlp.w_up", "mlp.w_down"]
    return paths + ["mlp.w_up", "mlp.w_down"]


def shared_linear_paths(cfg: ArchConfig) -> List[str]:
    """The hybrid family's shared-block linears: they live in
    ``params["shared_attn"]`` and tap as ``shared.*`` (the dense family's
    paths under the "shared." scope) at the layers where the block
    fires. None in the other families."""
    lm._check_family(cfg)
    if cfg.family != "hybrid" or not cfg.attn_every:
        return []
    return ["shared." + p for p in linear_paths(cfg.with_(family="dense"))]


def shared_layer(cfg: ArchConfig, params: dict) -> Optional[int]:
    """The layer where the hybrid's shared block is tapped and compressed:
    its first firing layer (None without a shared block)."""
    first = cfg.attn_every - 1
    if ("shared_attn" not in params or first < 0
            or not lm.shared_fires(cfg, first) or first >= cfg.n_layers):
        return None
    return first


def _tap_paths(cfg: ArchConfig, l: int, shared_at: Optional[int]
               ) -> List[str]:
    """The paths tapped at layer ``l``: its own linears, and the shared
    block's at ``shared_at``."""
    return linear_paths(cfg) + (shared_linear_paths(cfg)
                                if l == shared_at else [])


def _capture_layer(cfg: ArchConfig, params: dict, lp: dict, idx: int,
                   chunks: List[torch.Tensor],
                   positions: List[torch.Tensor],
                   paths: Sequence[str], hessian_names: Set[str],
                   propagate: bool = False
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Run layer ``idx``'s real forward over every calibration chunk under
    ONE tap capture, so statistics accumulate across chunks; returns
    (‖X‖₂ column norms, X^T X Hessians of ``hessian_names``), keyed by
    path. ``propagate`` writes each chunk's output back into ``chunks``
    (the uncompressed-model pass, where the capture forward is also the
    propagation)."""
    with tap_capture(hessian=bool(hessian_names),
                     hessian_names=hessian_names) as tap:
        for i in range(len(chunks)):
            out, _ = lm._layer_fwd(cfg, params, lp, idx, chunks[i],
                                   positions[i])
            if propagate:
                chunks[i] = out
    norms = {p: tap.norms(p) for p in paths if tap.has(p)}
    hess = {p: tap.hessian(p) for p in paths
            if tap.hessian(p) is not None}
    return norms, hess


def layer_tap_stats(cfg: ArchConfig, params: dict, lp: dict, idx: int,
                    h: torch.Tensor, positions: torch.Tensor,
                    hessian: bool = False,
                    hessian_names: Optional[Set[str]] = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """Single-batch wrapper around ``_capture_layer``: (act_norms,
    hessians) of layer ``idx`` on its input ``h``, keyed by path;
    ``hessians`` is empty unless requested (``hessian`` for every path,
    or ``hessian_names``)."""
    paths = linear_paths(cfg) + shared_linear_paths(cfg)
    names = (set(paths) if hessian and hessian_names is None
             else set(hessian_names or ()))
    return _capture_layer(cfg, params, lp, idx, [h], [positions], paths,
                          names)


def _calib_chunks(cfg: ArchConfig, params: dict, calib, dev
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The embedded calibration chunks of ``calib`` (an (N, S) id array,
    (N, S, D) float embeddings for a stub-frontend family, or a
    ``CalibrationSpec`` of either) and their positions ((N, S, 3) under
    M-RoPE), on ``dev``."""
    spec = (calib if isinstance(calib, plan_lib.CalibrationSpec)
            else plan_lib.CalibrationSpec(calib))
    chunks, positions = [], []
    for t in spec.batches():
        t = torch.as_tensor(t, device=dev)
        h = lm.embed_inputs(cfg, params,
                            t if t.is_floating_point() else t.long())
        chunks.append(h)
        positions.append(positions_for(cfg, h.shape[0], h.shape[1],
                                       device=dev))
    return chunks, positions


def stats_on(stats: ModelTapStats, dev: torch.device) -> ModelTapStats:
    """``stats`` with every norm and Hessian on ``dev``."""
    return ModelTapStats({k: v.to(dev) for k, v in stats.norms.items()},
                         {k: v.to(dev) for k, v in stats.hessians.items()},
                         stats.n_forwards)


def _device_for(params: dict, device, what: str) -> torch.device:
    """``resolve_device(device)``, which must be where ``params`` live."""
    dev = resolve_device(device)
    lm.check_params_on(params, dev, what)
    return dev


@torch.no_grad()
def collect_model_stats(cfg: ArchConfig, params: dict, calib,
                        plan=None, hessian_names=None,
                        progress: Optional[Callable[[str], None]] = None,
                        device=None) -> ModelTapStats:
    """ONE streaming calibration pass over the *uncompressed* model,
    tapping every layer's statistics (the allocator's probe and the
    input of ``compress_model(stats=...)``).

    Each layer's capture forward is also the propagation to the next
    layer (the weights do not change), so the pass costs ``n_layers *
    n_chunks`` ``_layer_fwd`` calls. Hessians are accumulated for the
    linears whose plan-resolved compressor needs them (``@auto`` rules
    probed at the base config); ``hessian_names`` overrides (a set of
    paths, or True for all). Runs on ``device`` (CUDA unless ``"cpu"``),
    where ``params`` must live."""
    dev = _device_for(params, device, "collect_model_stats")
    if plan is not None:
        plan = plan_lib.CompressionPlan.parse(plan)
    chunks, positions = _calib_chunks(cfg, params, calib, dev)
    norms: Dict[Tuple[int, str], torch.Tensor] = {}
    hessians: Dict[Tuple[int, str], torch.Tensor] = {}
    n_fwd = 0
    shared_at = shared_layer(cfg, params)
    for l in range(cfg.n_layers):
        paths = _tap_paths(cfg, l, shared_at)
        if hessian_names is True:
            hnames = set(paths)
        elif hessian_names is not None:
            hnames = set(hessian_names) & set(paths)
        elif plan is not None:
            hnames = set()
            for p in paths:
                r = plan.resolve(l, p, allow_auto=True)
                if r is not None and "hessian" in r.needs:
                    hnames.add(p)
        else:
            hnames = set()
        acts, hess = _capture_layer(cfg, params, params["layers"][l], l,
                                    chunks, positions, paths, hnames,
                                    propagate=True)
        n_fwd += len(chunks)
        for pth, an in acts.items():
            norms[(l, pth)] = an
        for pth, hz in hess.items():
            hessians[(l, pth)] = hz
        if progress:
            progress(f"stats layer {l + 1}/{cfg.n_layers} tapped")
    return ModelTapStats(norms, hessians, n_fwd)


def _weighted_errs(w: torch.Tensor, w_new: torch.Tensor,
                   an: Optional[torch.Tensor]) -> Tuple[float, float]:
    """(err_before, err_after) under the same tapped norms."""
    wt = w.T.float()
    err_b = float(scores_lib.weighted_fro_error(wt, torch.zeros_like(wt),
                                                an))
    err_a = float(scores_lib.weighted_fro_error(wt, w_new.T.float(), an))
    return err_b, err_a


def _expert_hessians(hz: Optional[torch.Tensor], n_exp: int, d_in: int
                     ) -> List[Optional[torch.Tensor]]:
    """Per-expert Hessian slices. An expert that saw no calibration
    tokens (all-zero Gram) takes the identity, which reduces
    Hessian-aware methods to magnitude pruning instead of zeroing it."""
    if hz is None:
        return [None] * n_exp
    tr = torch.diagonal(hz, dim1=-2, dim2=-1).sum(-1).reshape(-1).tolist()
    out: List[Optional[torch.Tensor]] = []
    for e in range(n_exp):
        if tr[e if len(tr) > 1 else 0] == 0.0:
            out.append(torch.eye(d_in, dtype=torch.float32,
                                 device=hz.device))
        else:
            out.append(hz[e] if hz.dim() == 3 else hz)
    return out


def _compress_experts(layer: int, pth: str, w: torch.Tensor,
                      an: Optional[torch.Tensor],
                      hz: Optional[torch.Tensor],
                      r: plan_lib.ResolvedCompression):
    """Compress a 3-D (E, D_in, D_out) expert leaf expert by expert.
    The decs travel as a tuple (``core.packed_model.pack_model`` packs
    it into an ``ExpertPackedStack``); the stats' variant is "expert"."""
    comp = r.compressor
    hz_e = _expert_hessians(hz, w.shape[0], w.shape[1])
    outs, crs, e_decs = [], [], []
    eb2 = ea2 = 0.0
    for e in range(w.shape[0]):
        an_e = an[e] if (an is not None and an.dim() == 2) else an
        cl = comp.compress(w[e].T.float(),
                           LinearStats(norms=an_e, hessian=hz_e[e]))
        o = cl.dense.T.to(w.dtype)
        outs.append(o)
        e_decs.append(cl.dec)
        if cl.cr is not None:
            crs.append(cl.cr)
        b_e, a_e = _weighted_errs(w[e], o, an_e)
        eb2 += b_e ** 2
        ea2 += a_e ** 2
    w_new = torch.stack(outs).contiguous()
    cr = float(np.mean(crs)) if crs else comp.scfg.cr
    dec = tuple(e_decs) if all(d is not None for d in e_decs) else None
    return w_new, dec, CompressStats(
        layer, pth, float(np.sqrt(eb2)), float(np.sqrt(ea2)), cr, r.method,
        "expert" if dec is not None else "",
        cr_requested=float(r.scfg.cr))


def _compress_leaf(layer: int, pth: str, w: torch.Tensor,
                   an: Optional[torch.Tensor], hz: Optional[torch.Tensor],
                   r: plan_lib.ResolvedCompression):
    """Compress one (D_in, D_out) model weight, or a 3-D expert leaf, with
    the resolved compressor ``r``. Returns (new weight, dec-or-None,
    CompressStats); the stats name the dec's variant."""
    if w.dim() == 3:
        return _compress_experts(layer, pth, w, an, hz, r)
    comp = r.compressor
    cl = comp.compress(w.T.float(), LinearStats(norms=an, hessian=hz))
    w_new = cl.dense.T.to(w.dtype).contiguous()
    err_b, err_a = _weighted_errs(w, w_new, an)
    cr = cl.cr if cl.cr is not None else comp.scfg.cr
    variant = ""
    if cl.dec is not None:
        from repro_torch.core.packed_model import variant_of
        variant = variant_of(cl.dec, r.scfg.pattern) or ""
    return w_new, cl.dec, CompressStats(layer, pth, err_b, err_a, cr,
                                        r.method, variant,
                                        cr_requested=float(r.scfg.cr))


def _compress_shared(out: dict, l: int, paths: Sequence[str],
                     resolved: dict, acts: dict, hess: dict, keep: bool,
                     decs: dict, out_stats: List[CompressStats]) -> None:
    """Compress the hybrid's shared block at its first firing layer ``l``
    into a copy of ``out["shared_attn"]``; decompositions are keyed
    ``(l, "shared.<path>")``."""
    sp = _copy_tree(out["shared_attn"])
    changed = False
    for pth in paths:
        r = resolved[pth]
        sub = pth.split(".", 1)[1]           # strip the "shared." scope
        w = _get(sp, sub)
        if r is None or w is None:
            continue
        w_new, dec, st = _compress_leaf(l, pth, w, acts.get(pth),
                                        hess.get(pth), r)
        if keep and dec is not None:
            decs[(l, pth)] = dec
        out_stats.append(st)
        _set(sp, sub, w_new)
        changed = True
    if changed:
        out["shared_attn"] = sp


@torch.no_grad()
def compress_model(cfg: ArchConfig, params: dict, calib,
                   method: str = "slab",
                   scfg: SLaBConfig = SLaBConfig(),
                   plan=None,
                   progress: Optional[Callable[[str], None]] = None,
                   keep_decompositions: bool = False,
                   stats: Optional[ModelTapStats] = None,
                   device=None):
    """Run the layer-wise protocol. Returns (new params, stats[, decs]);
    ``decs`` maps (layer, path) to the decomposition for
    ``core.packed_model.pack_model``.

    ``calib`` is an (N, S) int array of calibration token ids ((N, S, D)
    float embeddings for the audio family), or a
    ``plan.CalibrationSpec`` that streams it in chunks (the tap
    statistics accumulate across chunks). ``plan`` is anything
    ``CompressionPlan.parse`` takes; when None, ``method`` / ``scfg``
    are sugar for one catch-all rule. Hessians are tapped only for the
    linears whose resolved compressor needs them. ``stats`` (from ``collect_model_stats``)
    compresses from precollected statistics: no calibration forwards run
    (``calib`` may be None) and no error propagates. A plan that
    ``wants_allocation`` first goes through
    ``core.allocator.allocate_plan``, which collects ``stats`` when not
    given, so allocate + compress costs one calibration pass. Runs on
    ``device`` (CUDA unless ``"cpu"`` is passed), where ``params`` must
    already live."""
    dev = _device_for(params, device, "compress_model")
    plan = (plan_lib.CompressionPlan.parse(plan, base=scfg)
            if plan is not None else plan_lib.plan_for_method(method, scfg))
    if plan.wants_allocation:
        from repro_torch.core import allocator as allocator_lib
        allocation = allocator_lib.allocate_plan(
            cfg, params, calib, plan=plan, stats=stats, progress=progress,
            device=dev)
        plan, stats = allocation.plan, allocation.stats
    precollected = stats is not None
    if precollected:
        stats = stats_on(stats, dev)
    chunks: List[torch.Tensor] = []
    positions: List[torch.Tensor] = []
    if not precollected:
        if calib is None:
            raise ValueError("compress_model needs calibration data "
                             "(or precollected stats=)")
        chunks, positions = _calib_chunks(cfg, params, calib, dev)

    out = dict(params)
    out["layers"] = _copy_tree(params["layers"])
    out_stats: List[CompressStats] = []
    decs: Dict[Tuple[int, str], object] = {}
    shared_at = shared_layer(cfg, params)
    paths = linear_paths(cfg)
    for l in range(cfg.n_layers):
        lp = out["layers"][l]
        tap_paths = _tap_paths(cfg, l, shared_at)
        resolved = {p: plan.resolve(l, p) for p in tap_paths}
        if precollected:
            acts = {p: stats.norms[(l, p)] for p in tap_paths
                    if (l, p) in stats.norms}
            hess = {p: stats.hessians[(l, p)] for p in tap_paths
                    if (l, p) in stats.hessians}
        else:
            hess_names = {p for p, r in resolved.items()
                          if r is not None and "hessian" in r.needs}
            acts, hess = _capture_layer(cfg, out, lp, l, chunks, positions,
                                        tap_paths, hess_names)
        for pth in paths:
            r = resolved[pth]
            w = _get(lp, pth)
            if r is None or w is None:
                continue
            w_new, dec, st = _compress_leaf(l, pth, w, acts.get(pth),
                                            hess.get(pth), r)
            if keep_decompositions and dec is not None:
                decs[(l, pth)] = dec
            out_stats.append(st)
            _set(lp, pth, w_new)
        if l == shared_at:
            _compress_shared(out, l, shared_linear_paths(cfg), resolved,
                             acts, hess, keep_decompositions, decs,
                             out_stats)
        for i in range(len(chunks)):
            chunks[i], _ = lm._layer_fwd(cfg, out, lp, l, chunks[i],
                                         positions[i])
        if progress:
            progress(f"layer {l + 1}/{cfg.n_layers} compressed")
    if keep_decompositions:
        return out, out_stats, decs
    return out, out_stats
