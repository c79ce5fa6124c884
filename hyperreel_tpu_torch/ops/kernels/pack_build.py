"""Pack-build (K1): the prediction MLP and eval embedding tail of the
z-plane chains (the flagship's; the static llff_z_plane family's with its
scene contraction; the dynamic neural_3d_z_plane family's with the
contraction and a flow stage, 64 samples per ray), from the encoded rays
to the per-sample pack of ops/kernels/layout.py.

Replaces hyperreel_tpu/ops/pallas/pack_build.py:_pack_build_kernel with
its in-kernel MLP (_mlp_rows, the JAX package's default HYPERREEL_PK_MLP
route) and _bitonic_sublane. CUDA source: csrc/pack_build.cuh (host side
csrc/pack_build.cu). Bound on the H100 by the MLP's tensor-core products.
Under the bf16 policy a persistent block takes tiles of 128 rays: two
warpgroups of 64 rays run the layers as wgmma products on their
activations in shared memory and on weight slabs that TMA stages there
(`mlp_tables` lays the slabs out once per checkpoint, `tile_weights`), and
drain the last layer in strips of its columns (`kernel_strips`) into the
tail. The f32 policy runs plain FMAs, 64 rays per block, through the same
tail. The kernels take S in 8, 16, 32, 64; the plain version any S. See
the source for the design.

The MLP, under the bf16 policy as the JAX kernel's `_mlp_rows`: one bf16
rounding of each layer's input, weight and bias, f32 sums, the layer
activation in f32 and an f32 last layer (bf16 storage at that boundary
cost 3.2e-4 of rgb on the TPU against the 2e-4 gate). Under the f32
policy nothing is rounded. The encoded rays may be up to MAX_ENCODED
columns wide (the bf16 kernel multiplies them in steps of 32).

The activations: the MLP's layer activation and every field activation
are any elementwise kind of models/activations.py, or an ease_value /
interp_value over them, each handed to the kernel as its terms at the
launch's iteration (`kernel_terms`). A launch whose layer activation is
piecewise linear (identity, relu, a leaky relu or abs) and whose field
activations are each one identity, sigmoid or tanh runs the default
instantiation; any other, the generic one (PackParams.generic;
csrc/pack_build.cuh).

The tail, per sample, in order: the field activations; z = act(z)*(1 -
sigma)*z_scale + anchor, then z = inverse_contract_distance(z) when the
contraction places the anchors in contracted space; dist = (z - o_z)/d_z
(d_z guarded at 1e-5, dist <= 0 -> 0, or -> the far sentinel 1e9 for a
chain with invalid_sort_far); the values-only ascending sort of the S
distances (the flow, offset and colour fields stay in prediction order);
the k samples the pack keeps (PackSpec.k, .stride: the first k sorted
distances, or every stride-th, k * stride = S; each with the fields of
the prediction row at its sorted position: no field is sorted);
p = o + d*dist; under the mipnerf contraction p = contract_rows(p)
and dist = |p - contract_rows(o)| (0 where the sorted dist was 0); p +=
flow*dt (chains with a flow stage); p += offset*(1 - point_sigma); aabb
normalisation; the pack.

`pack_build(x0, mlp, ray_pack, spec, it)` takes
  x0       f32 [B, cin], the MLP's encoded input;
  mlp      the MlpTables of `mlp_tables` (built once per checkpoint);
  ray_pack f32 [B, 8]: o xyz, d xyz, dt = t - base_t, tn;
and returns the pack f32 [PACK_ROWS, B*k] (k = S unless the chain keeps
fewer). A CPU tensor goes to
`pack_build_plain`; a CUDA tensor launches the kernel or raises.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hyperreel_tpu_torch.models.activations import (
    Activation, MAX_LEAVES, kernel_act, leaf_value)
from hyperreel_tpu_torch.models.intersect import FAR_SENTINEL
from hyperreel_tpu_torch.models.mlp import round_to
from hyperreel_tpu_torch.ops.contract import IdentityContract
from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS, check_ray_pack

# field slots of the MLP row (PackParams.foff) and activation slots
# (PackParams.act), in the order of csrc/pack_build.cu
FIELDS = ("z", "sigma", "flow", "psig", "poff", "cs", "csh")
ACTS = ("z", "isect", "sigma", "flow", "flow_stage", "psig", "poff",
        "po_stage", "cs", "csh")
_IDENTITY = Activation("identity")
# the layer activations v >= 0 ? v : v * slope, by their slope (None: the
# leaky relu's own): the default instantiation's (PackParams.lpl, leaky)
_PIECEWISE = {"identity": 1.0, "relu": 0.0, "abs": -1.0, "leaky_relu": None}


def _piecewise_slope(act):
    """The slope below 0 of a piecewise-linear layer activation that K1
    applies inline (PackParams.lpl), else None."""
    if isinstance(act, Activation) and act.kind in _PIECEWISE \
            and act.leaf()[1:4] == (1.0, 1.0, 0.0):
        slope = _PIECEWISE[act.kind]
        return act.a if slope is None else slope
    return None
KERNEL_S = (8, 16, 32, 64)
MAX_ENCODED = 128    # encoded-ray columns of the bf16 kernel (csrc kMaxXCols)
NO_PLAN = -1         # pack_build_launch where no plan takes the launch
MAX_LAYERS = build.PACK_MAX_LAYERS
SLAB_K = 64          # the weight slabs' K rows: one 128-byte swizzle row
HIDDEN_BLOCK = 128   # hidden-layer columns per product (csrc kHiddenBlock)
POINT_GROUP = 16     # samples per point strip (csrc point_group)


def _ceil(x, m):
    return -(-x // m) * m


@dataclass
class MlpLayer:
    """out[:, :n] = A[:, k0:k0 + k] @ w + b (then the layer activation if
    `act`), A being the kernel's per-ray operand buffer."""
    w: torch.Tensor          # [k, n] in the operand dtype
    b: torch.Tensor          # f32 [n] (bf16-valued under the bf16 policy)
    k0: int
    act: bool


@dataclass
class MlpTables:
    """The prediction MLP as K1 reads it: per layer the transposed weight,
    zero-padded to k % 16 == 0 rows and n % 32 == 0 columns, in the
    operand dtype. The encoded input sits in operand columns
    [xcol, xcol + cin); the skip layer reads [hidden, input] from columns
    [0, xcol + cin_pad); the last layer's columns are field-major."""
    layers: List[MlpLayer]
    cin: int
    xcol: int
    layer_act: object        # models.activations: an elementwise one
    compute_dtype: object    # torch.bfloat16 or None (f32)
    # the bf16 kernel's weight slabs (`tile_weights`) and the rows of each;
    # None under the f32 policy or where the widths do not slab
    tiled: Optional[torch.Tensor] = None
    slab_rows: Optional[List[int]] = None


def kernel_strips(S):
    """The last layer's strips in the bf16 kernel's order, each
    (channels, s0, ns): its (field, component) channels, each over samples
    [s0, s0 + ns): z and sigma, point sigma, per group of POINT_GROUP
    samples (all S if fewer) the six point channels (flow xyz, offset xyz),
    then each component of colour scale and colour shift. The kernel's
    tail is written for this order (csrc/pack_build.cuh strip_desc,
    strip_channel); PackSpec.params passes it with the slabs, and the
    launch is refused where the two differ."""
    g = min(S, POINT_GROUP)
    point = [("flow", c) for c in range(3)] + [("poff", c) for c in range(3)]
    return [([("z", 0), ("sigma", 0)], 0, S), ([("psig", 0)], 0, S),
            *[(point, s0, g) for s0 in range(0, S, g)],
            *[([(f, c)], 0, S) for f in ("cs", "csh") for c in range(3)]]


def strip_columns(spec):
    """Per strip, the field-major last-layer column of each of its columns
    (channel-major, sample-minor); -1 for a field the chain lacks (flow in
    a static chain) and for the pad up to a multiple of 32."""
    out = []
    for chans, s0, ns in kernel_strips(spec.S):
        cols = [(spec.foff[f] + c) * spec.S + s0 + s if f in spec.foff
                else -1 for f, c in chans for s in range(ns)]
        out.append(cols + [-1] * (_ceil(len(cols), 32) - len(cols)))
    return out


def tile_weights(layers, xcol, strips):
    """The bf16 kernel's weights as slabs of SLAB_K k-rows, each stored
    transposed ([n, SLAB_K], K-major: what one TMA load puts in a ring
    stage, the hardware adding the 128-byte swizzle), in the order the
    kernel consumes them per ray tile: per hidden layer and column block
    of HIDDEN_BLOCK the slabs of its hidden rows, then one of its
    encoded-ray rows where it reads them; per strip of the last layer
    (`strip_columns`) the slabs of its columns. Pad rows and columns are
    zero. Returns the slabs [sum of n, SLAB_K] and the n of each, which
    the launch checks slab by slab against the kernel's order; None where
    the hidden width is not a multiple of SLAB_K or the encoded rays exceed
    MAX_ENCODED columns. The encoded-ray rows take a slab per SLAB_K of
    them."""
    H = layers[0].w.shape[1]
    cp = layers[0].w.shape[0]
    if H % SLAB_K or cp > MAX_ENCODED:
        return None

    def slab(rows):                           # [k <= SLAB_K, n] -> [n, K]
        return F.pad(rows, (0, 0, 0, SLAB_K - rows.shape[0])).t()

    slabs = []
    hb = min(H, HIDDEN_BLOCK)
    for l in layers[:-1]:
        for c in range(0, H, hb):             # the kernel's column blocks
            w = l.w[:, c:c + hb]
            if l.k0 == 0:
                slabs += [slab(w[j:j + SLAB_K]) for j in range(0, H, SLAB_K)]
            if l.k0 + l.w.shape[0] > xcol:
                x = w[xcol - l.k0:xcol - l.k0 + cp]
                slabs += [slab(x[j:j + SLAB_K]) for j in range(0, cp, SLAB_K)]
    w = layers[-1].w
    for cols in strips:
        idx = torch.as_tensor(cols, device=w.device)
        ws = w[:, idx.clamp(min=0)] * (idx >= 0).to(w.dtype)
        slabs += [slab(ws[j:j + SLAB_K]) for j in range(0, H, SLAB_K)]
    return torch.cat(slabs).contiguous(), [s.shape[0] for s in slabs]


def mlp_tables(net, params, perm, spec):
    """BaseMLP `net` with nn.Linear-layout `params` -> MlpTables; `perm`
    maps field-major output column -> the MLP's own column; `spec` (the
    chain's PackSpec) gives the last layer's strips."""
    if not kernel_act(net.layer_act) or net.activation != "identity" \
            or net.pe_cfg:
        raise ValueError(
            "K1 runs MLPs with an elementwise layer activation, an identity "
            "output and no PE of their own (models/fused_eval.py "
            "cf_eligible)")
    if net.compute_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(f"MLP policy {net.compute_dtype}")
    if net.depth + 2 > MAX_LAYERS:
        raise NotImplementedError(f"K1 takes <= {MAX_LAYERS} layers")
    cd = net.compute_dtype
    cin, cp, hp = net.in_channels, _ceil(net.in_channels, 16), \
        _ceil(net.hidden, 32)
    last = net.depth + 1

    def pad(m, rows, cols):
        return F.pad(m, (0, cols - m.shape[1], 0, rows - m.shape[0]))

    layers = []
    for i in range(net.depth + 2):
        p = params[f"layer_{i}"]
        w = p["weight"].float().t()                       # [in, out]
        b = p["bias"].float() if "bias" in p else w.new_zeros(w.shape[1])
        if i == last:
            w, b = w[:, perm.to(w.device)], b[perm.to(w.device)]
        n = hp if i < last else _ceil(w.shape[1], 32)
        if i == 0:
            blocks, k0 = [(w, cp)], hp
        elif i in net.skips:                 # weight rows [input, hidden]
            blocks, k0 = [(w[cin:], hp), (w[:cin], cp)], 0
        else:
            blocks, k0 = [(w, hp)], 0
        wt = torch.cat([pad(m, k, n) for m, k in blocks], 0)
        layers.append(MlpLayer(
            w=wt.to(cd or torch.float32).contiguous(),
            b=round_to(F.pad(b, (0, n - b.shape[0])), cd).contiguous(),
            k0=k0, act=i < net.act_until))
    tiled = tile_weights(layers, hp, strip_columns(spec)) \
        if cd is not None else None
    return MlpTables(layers, cin, hp, net.layer_act, cd,
                     *(tiled or (None, None)))


@dataclass
class PackSpec:
    """Static description of one chain's embedding tail.

    foff: field slot -> channel offset in the MLP row; every slot of
          FIELDS but "flow" is required (static chains have no flow).
    acts: activation slot -> a models.activations activation that K1
          takes (kernel_act; absent slots are identity).
    contract: the intersect's ops.contract contraction (identity or
          mipnerf).
    k, stride: the samples the pack keeps (hyperreel_tpu/ops/pallas/
          pack_build.py:161-175, :198-207): the first k sorted positions
          (stride None; k = S, the default, keeps all), or with a stride
          >= 2, k * stride = S, the positions 0, stride, 2 stride, ...
          (the reference's inference_samples); each with the fields of
          the prediction row at that position.
    far_sentinel: the distance of an invalid sample before the sort (the
          intersect's invalid_sort_far, models/intersect.py FAR_SENTINEL),
          None for 0.
    """
    S: int
    P: int
    foff: Dict[str, int]
    acts: Dict[str, object]
    samples: np.ndarray      # [S] z anchors
    z_scale: np.ndarray      # [S]
    aabb: np.ndarray         # [2, 3]
    contract: object = IdentityContract()
    k: Optional[int] = None
    stride: Optional[int] = None
    far_sentinel: Optional[float] = None

    def __post_init__(self):
        missing = [k for k in FIELDS if k not in self.foff and k != "flow"]
        if missing:
            raise NotImplementedError(
                f"chain without {missing}: K1 takes the flagship's fields "
                "(ROADMAP.md: long tail)")
        if self.k is None:
            self.k = self.S
        if not 1 <= self.k <= self.S or (self.stride is not None and (
                self.stride < 2 or self.k * self.stride != self.S)):
            raise ValueError(f"keeping k={self.k} of S={self.S} samples "
                             f"at stride {self.stride}")

    def kept(self):
        """The kept sorted positions (and prediction rows) of a ray."""
        return slice(None, None, self.stride) if self.stride \
            else slice(None, self.k)

    def terms(self, it):
        """Each activation slot's kernel_terms at iteration `it`."""
        return {k: self.acts.get(k, _IDENTITY).kernel_terms(it)
                for k in ACTS}

    def generic(self, mlp, it):
        """Whether the launch takes the generic instantiation: a layer
        activation other than identity, relu, a leaky relu or abs, or a
        field activation other than one identity, sigmoid or tanh."""
        return (_piecewise_slope(mlp.layer_act) is None
                or not all(self.acts.get(k, _IDENTITY).basic() for k in ACTS))

    def params(self, B, mlp, it):
        """The kernel's PackParams for B rays at iteration `it`."""
        p = build.PackParams()
        p.B, p.S, p.P = B, self.S, self.P
        p.k, p.stride = self.k, self.stride or 1
        p.far = float(self.far_sentinel or 0.0)
        p.cin, p.xcol, p.n_layers = mlp.cin, mlp.xcol, len(mlp.layers)
        p.bf16 = int(mlp.compute_dtype is not None)
        slope = _piecewise_slope(mlp.layer_act)
        p.lpl, p.leaky = int(slope is not None), slope or 0.0
        p.generic = int(self.generic(mlp, it))
        _set_act(p.lact, mlp.layer_act.kernel_terms(it))
        for i, l in enumerate(mlp.layers):
            p.layer[i] = build.MlpLayer(l.w.data_ptr(), l.b.data_ptr(), l.k0,
                                        l.w.shape[0], l.w.shape[1],
                                        int(l.act))
        for i, k in enumerate(FIELDS):
            p.foff[i] = self.foff.get(k, -1)
        c = self.contract
        if c.name == "mipnerf":
            p.contract, p.contract_samples = 1, int(c.contract_samples)
            for k in ("start_r", "inv_end_r", "r_scale", "start_d",
                      "inv_end_d", "d_scale"):
                setattr(p, "c_" + k, float(getattr(c, k)))
        for i, t in enumerate(self.terms(it).values()):
            _set_act(p.act[i], t)
        for s in range(self.S):
            p.samples[s] = float(self.samples[s])
            p.z_scale[s] = float(self.z_scale[s])
        lo = np.asarray(self.aabb, np.float32)
        inv = (2.0 / (lo[1] - lo[0])).astype(np.float32)
        for c in range(3):
            p.aabb_lo[c] = float(lo[0][c])
            p.aabb_inv[c] = float(inv[c])
        if mlp.tiled is not None:
            p.wt, p.wt_rows = mlp.tiled.data_ptr(), mlp.tiled.shape[0]
            p.n_slabs = len(mlp.slab_rows)
            for j, n in enumerate(mlp.slab_rows[:build.PACK_MAX_SLABS]):
                p.slab_rows[j] = n
            strips = kernel_strips(self.S)[:build.PACK_MAX_STRIPS]
            p.n_strips = len(strips)
            for q, (chans, s0, ns) in enumerate(strips):
                p.strip_s[q][0], p.strip_s[q][1] = s0, ns
                for j in range(build.PACK_STRIP_CHANNELS):
                    p.strip_fc[q][j] = (4 * FIELDS.index(chans[j][0])
                                        + chans[j][1]) if j < len(chans) \
                        else -1
        return p


def _set_act(a, terms):
    """Fill a build.Act from kernel_terms (c0, ((c, leaf), ...))."""
    c0, leaves = terms
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"K1 takes 1-{MAX_LEAVES} activation leaves")
    a.n, a.c0 = len(leaves), float(c0)
    for i, (c, (kind, inner, outer, shift, par)) in enumerate(leaves):
        a.c[i] = float(c)
        a.f[i] = build.ActLeaf(int(kind), float(inner), float(outer),
                               float(shift), float(par))


def apply_terms(x, terms):
    """An activation in the kernel's form: c0 + sum c * f_leaf(x), in the
    kernel's order."""
    c0, leaves = terms
    (c, leaf), *rest = leaves
    v = c * leaf_value(leaf, x) + c0
    for c, leaf in rest:
        v = v + c * leaf_value(leaf, x)
    return v


def mlp_plain(x0, mlp, it=None):
    """Plain PyTorch version of the kernel's MLP: [B, cin] -> f32 [B, n]
    of the last layer (field-major columns, zero-padded); the layer
    activation's schedule at iteration `it` (None: without a context, as
    the JAX closures take ctx None)."""
    terms = mlp.layer_act.kernel_terms(it)
    cols = max(l.k0 + l.w.shape[0] for l in mlp.layers)
    A = x0.new_zeros(x0.shape[0], cols)
    A[:, mlp.xcol:mlp.xcol + mlp.cin] = x0
    for i, l in enumerate(mlp.layers):
        y = round_to(A[:, l.k0:l.k0 + l.w.shape[0]], mlp.compute_dtype) \
            @ l.w.float() + l.b
        if l.act:
            y = apply_terms(y, terms)
        if i + 1 < len(mlp.layers):
            A[:, :y.shape[1]] = y
    return y


def tail_plain(mlp_out, ray_pack, spec, it):
    """Plain PyTorch version of the kernel's tail: the MLP's field-major
    f32 output [B, >= P*S] -> the pack."""
    B, S = ray_pack.shape[0], spec.S
    dsc = spec.terms(it)
    rows3 = mlp_out[:, :spec.P * S].reshape(B, spec.P, S)
    keep = spec.kept()

    def field(slot, act, c=0, rows=keep):
        return apply_terms(rows3[:, spec.foff[slot] + c, rows], dsc[act])

    o, d, dt = ray_pack[:, 0:3], ray_pack[:, 3:6], ray_pack[:, 6:7]
    every = slice(None)
    z = apply_terms(field("z", "z", rows=every), dsc["isect"])
    z = z * (1.0 - field("sigma", "sigma", rows=every))
    dev = mlp_out.device
    z = z * torch.as_tensor(spec.z_scale, dtype=torch.float32, device=dev) \
        + torch.as_tensor(spec.samples, dtype=torch.float32, device=dev)
    contract = spec.contract
    if contract.contract_samples:
        z = contract.inverse_contract_distance(z)
    dz = torch.where(d[:, 2:3].abs() < 1e-5,
                     torch.full_like(d[:, 2:3], 1e12), d[:, 2:3])
    dist = (z - o[:, 2:3]) / dz
    dist = torch.where(dist <= 0.0, torch.full_like(
        dist, spec.far_sentinel or 0.0), dist)
    dist = torch.sort(dist, dim=-1).values[:, keep]

    base = [o[:, c:c + 1] + d[:, c:c + 1] * dist for c in range(3)]
    if contract.name != "identity":
        pc = contract.contract_rows(*base)
        oc = contract.contract_rows(o[:, 0:1], o[:, 1:2], o[:, 2:3])
        d_c = torch.sqrt(torch.clamp_min(
            (pc[0] - oc[0]) ** 2 + (pc[1] - oc[1]) ** 2
            + (pc[2] - oc[2]) ** 2, 1e-24))
        dist = torch.where(dist <= 0.0, torch.zeros_like(dist), d_c)
        base = list(pc)
    po_fac = 1.0 - field("psig", "psig")
    aabb = np.asarray(spec.aabb, np.float32)
    inv = (2.0 / (aabb[1] - aabb[0])).astype(np.float32)
    pts = []
    for c in range(3):
        p = base[c]
        if "flow" in spec.foff:
            p = p + apply_terms(field("flow", "flow", c),
                                dsc["flow_stage"]) * dt
        p = p + apply_terms(field("poff", "poff", c),
                            dsc["po_stage"]) * po_fac
        pts.append((p - float(aabb[0][c])) * float(inv[c]) - 1.0)
    rows = pts + [dist] + [field(slot, slot, c) for slot in ("cs", "csh")
                           for c in range(3)]
    return torch.stack(rows, 0).reshape(PACK_ROWS, B * spec.k)


def pack_build_plain(x0, mlp, ray_pack, spec, it):
    """Plain PyTorch version of the kernel (same inputs and output)."""
    return tail_plain(mlp_plain(x0, mlp, it), ray_pack, spec, it)


def pack_error(pack, ref, far_sentinel=FAR_SENTINEL, skip=None):
    """(max |pack - ref| over every element but the points of the samples
    at the far sentinel, max |pack - ref| / |ref| over those points), for
    holding K1 against its plain version: a sentinel sample's point lies
    ~1e8 outside the aabb, where one f32 rounding more or less (a
    multiply-add that the compiler fuses, the plain version rounding
    twice) moves it by 8-16, so only its relative error means anything.
    `skip` (bool [B]): rays whose rows 0-3 are left out, those that
    `sentinel_flips` holds instead; their colour rows are compared."""
    geo = torch.ones_like(ref[3], dtype=torch.bool)
    if skip is not None:
        geo = ~skip.repeat_interleave(ref.shape[1] // skip.shape[0])
    far = (ref[3] == far_sentinel) & geo
    d = (pack - ref).abs()
    err = torch.cat([d[:, ~far & geo].flatten(), d[3:, far].flatten(),
                     d[4:, ~geo].flatten()]).max()
    rel = (d[:3, far] / ref[:3, far].abs()).max().item() if far.any() \
        else 0.0
    return err.item(), rel


def sentinel_flips(pack, ref, ray_pack, spec, tol):
    """The rays on which two packs of one chain (K1 and its plain version)
    disagree about which samples are invalid, and the largest error over
    those rays once that is accounted for: (bool [B], float).

    A sample whose distance lies within rounding of 0 may fall on either
    side of the `dist <= 0` test: the bf16 MLP sums its products in
    another order on each side, so its predicted z moves by ~1e-5. On one
    side it is valid, the nearest sample of its ray; on the other it takes
    the far sentinel and sorts last, so every sorted position of that ray
    moves by one. Such a ray passes when the side with more valid samples
    has exactly its first m (the count of flips) at distances in (0, tol],
    its remaining valid distances match the other side's shifted by m, and
    rows 0-2 less d * dist (the flow and offset fields of each prediction
    row, which the sort does not move) match at every position valid on
    both sides, all within `tol`. Only chains that keep every sample at
    the far sentinel with no contraction are aligned so; for any other
    chain no ray is returned and `pack_error` sees the flip whole."""
    B, k = ray_pack.shape[0], spec.k
    flips = torch.zeros(B, dtype=torch.bool, device=pack.device)
    sent = spec.far_sentinel
    if sent is None or spec.stride or k != spec.S \
            or spec.contract.name != "identity":
        return flips, 0.0
    p, r = pack[:4].reshape(4, B, k), ref[:4].reshape(4, B, k)
    n_p, n_r = (p[3] == sent).sum(1), (r[3] == sent).sum(1)
    flips = n_p != n_r
    if not flips.any():
        return flips, 0.0
    more = (n_p < n_r)[flips][None, :, None]     # the pack keeps more
    a = torch.where(more, p[:, flips], r[:, flips])
    b = torch.where(more, r[:, flips], p[:, flips])
    m = (n_p - n_r).abs()[flips][:, None]
    nb = k - torch.maximum(n_p, n_r)[flips][:, None]
    j = torch.arange(k, device=pack.device)[None]
    extra = a[3][j < m]
    if extra.min() <= 0.0:
        return flips, float("inf")
    both = j < nb
    a_shift = torch.gather(a[3], 1, (j + m).clamp_max(k - 1))
    aabb = np.asarray(spec.aabb, np.float32)
    inv = torch.as_tensor((2.0 / (aabb[1] - aabb[0])).astype(np.float32),
                          device=pack.device)
    dn = ray_pack[flips, 3:6].T[:, :, None] * inv[:, None, None]
    res = (a[:3] - dn * a[3]) - (b[:3] - dn * b[3])
    zero = torch.zeros((), device=pack.device)
    err = max(extra.max().item(),
              torch.where(both, (a_shift - b[3]).abs(), zero).max().item(),
              torch.where(both, res.abs().amax(0), zero).max().item())
    return flips, err


def _check(x0, mlp, ray_pack, spec):
    B = x0.shape[0]
    if x0.dtype != torch.float32 or tuple(x0.shape) != (B, mlp.cin) \
            or not x0.is_contiguous():
        raise ValueError(f"x0 must be contiguous f32 (B, {mlp.cin}), got "
                         f"{x0.dtype} {tuple(x0.shape)}")
    check_ray_pack(ray_pack, B)
    wdt = mlp.compute_dtype or torch.float32
    for l in mlp.layers:
        if l.w.dtype != wdt or l.b.dtype != torch.float32 \
                or not (l.w.is_contiguous() and l.b.is_contiguous()) \
                or l.w.data_ptr() % 32:
            raise ValueError("MLP tables must be contiguous, 32-byte "
                             f"aligned {wdt} weights with f32 biases")
        if l.w.device != x0.device or l.b.device != x0.device:
            raise ValueError("MLP tables lie on another device than x0")
    if spec.P * spec.S > mlp.layers[-1].w.shape[1]:
        raise ValueError("the MLP's last layer is narrower than P*S")
    if mlp.tiled is not None and mlp.tiled.device != x0.device:
        raise ValueError("MLP tables lie on another device than x0")
    if x0.device != ray_pack.device:
        raise ValueError("x0 and ray_pack lie on different devices")
    return B


def pack_build(x0, mlp, ray_pack, spec, it):
    """Run K1 (see the module docstring); counts launches in
    `pack_build.launches`."""
    B = _check(x0, mlp, ray_pack, spec)
    if x0.device.type == "cpu":
        return pack_build_plain(x0, mlp, ray_pack, spec, it)
    if x0.device.type != "cuda":
        raise ValueError(f"pack_build has no kernel for {x0.device}")
    if spec.S not in KERNEL_S:
        raise NotImplementedError(
            f"pack_build kernel: S={spec.S} not built (S in {KERNEL_S}: "
            "channels of whole 8-column accumulator blocks, a warp lane per "
            "sample, two at S = 64)")
    if mlp.compute_dtype is not None and mlp.tiled is None:
        raise NotImplementedError(
            "pack_build kernel: the MLP's widths do not slab (hidden width "
            f"a multiple of {SLAB_K}, at most {MAX_ENCODED} encoded "
            "columns: the encoded rays' chunks of A beside the weight ring "
            "in shared memory)")
    lib = build.load_library().lib
    params = spec.params(B, mlp, it)
    pack = torch.empty((PACK_ROWS, B * spec.k), dtype=torch.float32,
                       device=x0.device)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pack_build_launch(x0.data_ptr(), ray_pack.data_ptr(),
                                   pack.data_ptr(), params, stream)
    if rc == NO_PLAN:
        raise NotImplementedError(
            f"pack_build kernel: no launch plan for these widths (S={spec.S},"
            f" {mlp.layers[0].w.shape[0]} encoded columns, the "
            f"{'bf16' if params.bf16 else 'f32'} kernel's "
            f"{'generic' if params.generic else 'default'} instantiation): "
            + ("the encoded rays' chunks of A, the tail buffers and the "
               "generic instantiation's staging buffers leave fewer than "
               "two weight-ring stages of shared memory (csrc/pack_build.cu"
               " plan_wgmma)" if params.bf16 else
               "the two f32 operand buffers of 64 rays x the widest layer "
               "input and the tail buffers exceed 227 KB of shared memory "
               "(csrc/pack_build.cu plan_f32)"))
    build.check_launch(rc, "pack_build")
    pack_build.launches += 1
    return pack


pack_build.launches = 0
