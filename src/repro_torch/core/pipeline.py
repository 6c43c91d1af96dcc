"""Layer-wise one-shot compression loop (port of
``repro.core.pipeline``, one method per call, dense and moe families).

  for each transformer layer, in order:
    (1) forward the calibration set through the already-compressed
        prefix to the layer's inputs,
    (2) run the layer's real forward (``models.lm._layer_fwd``) under one
        ``tap_capture``: the ``linear()`` chokepoint reports every
        linear's exact input, reduced on the fly to ‖X‖₂ column norms
        and, when the method's ``needs`` holds "hessian", to the X^T X
        Gram matrix,
    (3) compress every linear with the method's compressor,
    (4) replace the weights and continue forward with the compressed
        layer's outputs (error propagation).

Params hold one dict per layer (``params["layers"][l]``); weights are
stored (D_in, D_out) in the model and transposed to the paper's
(D_out, D_in) for the compressor and back. MoE experts, (E, D_in, D_out)
leaves, are compressed one expert at a time from that expert's own
tapped statistics (the tokens dispatched to it), and their
decompositions travel as a tuple, one per expert.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import compressor as compressor_lib
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
    linears when ``cfg.shared_ff`` is set."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
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


def _capture_layer(cfg: ArchConfig, params: dict, lp: dict, idx: int,
                   chunks: List[torch.Tensor],
                   positions: List[torch.Tensor],
                   paths: Sequence[str], hessian_names: Set[str]
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Run layer ``idx``'s real forward over every calibration chunk under
    ONE tap capture; returns (‖X‖₂ column norms, X^T X Hessians of
    ``hessian_names``), keyed by path."""
    with tap_capture(hessian=bool(hessian_names),
                     hessian_names=hessian_names) as tap:
        for i in range(len(chunks)):
            lm._layer_fwd(cfg, params, lp, idx, chunks[i], positions[i])
    norms = {p: tap.norms(p) for p in paths if tap.has(p)}
    hess = {p: tap.hessian(p) for p in paths
            if tap.hessian(p) is not None}
    return norms, hess


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
                      comp: compressor_lib.Compressor):
    """Compress a 3-D (E, D_in, D_out) expert leaf expert by expert.
    The decs travel as a tuple (``core.packed_model.pack_model`` packs
    it into an ``ExpertPackedStack``); the stats' variant is "expert"."""
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
    return w_new, dec, CompressStats(layer, pth, float(np.sqrt(eb2)),
                                     float(np.sqrt(ea2)), cr, comp.name,
                                     "expert" if dec is not None else "")


def _compress_leaf(layer: int, pth: str, w: torch.Tensor,
                   an: Optional[torch.Tensor], hz: Optional[torch.Tensor],
                   comp: compressor_lib.Compressor):
    """Compress one (D_in, D_out) model weight, or a 3-D expert leaf.
    Returns (new weight, dec-or-None, CompressStats); the stats name the
    dec's variant."""
    if w.dim() == 3:
        return _compress_experts(layer, pth, w, an, hz, comp)
    cl = comp.compress(w.T.float(), LinearStats(norms=an, hessian=hz))
    w_new = cl.dense.T.to(w.dtype).contiguous()
    err_b, err_a = _weighted_errs(w, w_new, an)
    cr = cl.cr if cl.cr is not None else comp.scfg.cr
    variant = ""
    if cl.dec is not None:
        from repro_torch.core.packed_model import variant_of
        variant = variant_of(cl.dec, comp.scfg.pattern) or ""
    return w_new, cl.dec, CompressStats(layer, pth, err_b, err_a, cr,
                                        comp.name, variant)


@torch.no_grad()
def compress_model(cfg: ArchConfig, params: dict, calib,
                   method: str = "slab",
                   scfg: SLaBConfig = SLaBConfig(),
                   keep_decompositions: bool = False,
                   device=None):
    """Run the layer-wise protocol with one method (any name of
    ``core.compressor.available()``) on every linear.
    Returns (new params, stats[, decs]); ``decs`` maps (layer, path) to
    the decomposition for ``core.packed_model.pack_model``.

    ``calib`` is an (N, S) int array of calibration token ids. Runs on
    ``device`` (CUDA unless ``"cpu"`` is passed), where ``params`` must
    already live."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"compress_model was asked to run on {dev}")
    comp = compressor_lib.get(method, scfg)
    toks = torch.as_tensor(np.asarray(calib), device=dev).long()
    h = lm.embed_inputs(cfg, params, toks)
    chunks = [h]
    positions = [positions_for(cfg, h.shape[0], h.shape[1], device=dev)]

    out = dict(params)
    out["layers"] = _copy_tree(params["layers"])
    out_stats: List[CompressStats] = []
    decs: Dict[Tuple[int, str], object] = {}
    paths = linear_paths(cfg)
    hess_names = set(paths) if "hessian" in comp.needs else set()
    for l in range(cfg.n_layers):
        lp = out["layers"][l]
        acts, hess = _capture_layer(cfg, out, lp, l, chunks, positions,
                                    paths, hess_names)
        for pth in paths:
            w = _get(lp, pth)
            if w is None:
                continue
            w_new, dec, st = _compress_leaf(l, pth, w, acts.get(pth),
                                            hess.get(pth), comp)
            if keep_decompositions and dec is not None:
                decs[(l, pth)] = dec
            out_stats.append(st)
            _set(lp, pth, w_new)
        for i in range(len(chunks)):
            chunks[i], _ = lm._layer_fwd(cfg, out, lp, l, chunks[i],
                                         positions[i])
    if keep_decompositions:
        return out, out_stats, decs
    return out, out_stats
