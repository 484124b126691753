"""GRU recurrence through one hand-written CUDA kernel per layer.

Counterpart of ``tennis_tpu/ops/pallas/gru.py``. The input projection of the
whole sequence is one large matmul outside the kernel (the cuDNN trick, as
in ``RNNLayer``); what remains is the strictly sequential (B, H) x (H, 3H)
recurrence, which one launch runs for all T steps. Four kernels compute it:

- ``"async"``, ``csrc/gru_recurrence_async.cu``: a cluster of 8 or 16 CTAs
  per chunk of up to 8 batch rows, each thread keeping its share of Wh in
  registers (the rest in shared memory), the new hidden state sent to every
  CTA with ``st.async`` and awaited on an mbarrier; no cluster barrier
  inside the loop. It takes H up to 512, multiples of 8 or 16 with a
  partition the source takes (``gru_plan``).
- ``"general"``, ``csrc/gru_recurrence_general.cu``: every H from 1 to
  1023 (``general_plan``): a cluster of min(16, H) CTAs owning ragged runs
  of units, the async kernel's exchange, Wh in registers and shared memory
  as far as they hold it and the rest streamed from L2 every step.
- ``"grid"``, ``csrc/gru_recurrence_grid.cu``: where the general kernel
  streams (H past ~560): Wh held whole over several clusters of 16 CTAs
  (``grid_plan``), loaded once, the new hidden state exchanged between all
  of them through L2 with a release/acquire counter; a cooperative launch.
- ``"barrier"``, ``csrc/gru_recurrence.cu``: a cluster of 8 CTAs, Wh in
  shared memory, one cluster barrier a step; H up to 368. Kept for the A/B.

``gru_recurrence`` routes each (T, B, H) to the async kernel where it takes
the shape (the card measured it fastest there), to the grid kernel where the
general one would stream Wh, and to the general one elsewhere
(``gru_route``). Beside the kernels sits their plain PyTorch
version, ``gru_recurrence_reference``. The launch is the ``torch.library``
custom op ``tennis_torch::gru_recurrence`` (:func:`gru_recurrence_op`),
whose CUDA implementation launches a kernel or raises and whose CPU
implementation is the plain version; ``torch.export`` keeps it as one node.
The kernels are forward-only, like the TPU one: on the card, with a
gradient required, the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

SMEM_LIMIT = 232448    # 227 KiB: the most dynamic shared memory a CTA can use
MAX_HIDDEN = 512       # the widest H the async kernel takes (its kMaxH)
VARIANTS = ("barrier", "async", "general", "grid")

# "barrier" (csrc/gru_recurrence.cu)
CLUSTER = 8            # CTAs per cluster (csrc kCluster)
MAX_THREADS = 384      # threads per CTA (csrc kMaxThreads)
MAX_ROWS = 8           # batch rows per cluster (csrc kMaxRows)


def _split(H: int, B: int) -> tuple[int, int]:
    """(S, R) of the barrier kernel: segments of each dot product and batch
    rows per cluster. S is the largest power of two with 3H/8 * S <= 384
    threads and H / S a multiple of 4; R = min(8, 3S, B) keeps every (row,
    unit) pair on its own thread."""
    J = 3 * (H // CLUSTER)
    S = 1
    while J * S * 2 <= MAX_THREADS and H % (8 * S) == 0:
        S *= 2
    return S, max(1, min(MAX_ROWS, 3 * S, B))


def _smem_bytes(H: int, S: int, R: int) -> int:
    J = 3 * (H // CLUSTER)
    return 4 * (H * J + 2 * R * H + S * R * J)


def barrier_fits(H: int, B: int) -> bool:
    """Whether the barrier kernel takes hidden size H: H a multiple of 8,
    and one CTA's 3H/8 columns of Wh plus its double-buffered h and partial
    sums in 227 KiB of shared memory (up to H = 368 at any batch)."""
    if H < CLUSTER or H % CLUSTER:
        return False
    return _smem_bytes(H, *_split(H, max(B, 1))) <= SMEM_LIMIT


# "async" (csrc/gru_recurrence_async.cu), mirrored: constants of the source
# C, template instances, in the order gru_plan prefers them: 16 CTAs were
# the faster at every shape chip_smoke.py measures (PERF.md)
ASYNC_CLUSTERS = (16, 8)
ASYNC_MAX_THREADS = 256    # kMaxThreads
ASYNC_MAX_ROWS = 8         # kMaxRows
REG_ROWS = 32              # kRegL: rows of each column a thread keeps in registers
STATIC_SMEM = 64           # the launcher's allowance for the two mbarriers


class GruPlan(NamedTuple):
    """The async kernel's partition of one (H, B): ``cluster`` CTAs of
    ``threads`` = ``units`` x ``segments`` threads per chunk of ``rows``
    batch rows; thread (u, s) sums rows [s L, (s + 1) L) of the r, z and n
    columns of its unit, L = H / segments: ``reg_weights`` of those 3L
    weights from registers, ``smem_weights`` from shared memory.
    ``smem_bytes`` is the CTA's dynamic shared memory."""
    cluster: int
    units: int
    segments: int
    rows: int
    threads: int
    reg_weights: int
    smem_weights: int
    smem_bytes: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


@functools.lru_cache(maxsize=256)
def _async_plan(H: int, B: int, C: int) -> GruPlan | None:
    if H <= 0 or H > MAX_HIDDEN or H % C:
        return None
    U = H // C
    # S: the largest power of two with U S threads and L = H / S a row count
    # the source takes (8, 16, or a multiple of 4 from REG_ROWS up)
    S = next((s for s in (1 << i for i in range(8, -1, -1))
              if U * s <= ASYNC_MAX_THREADS and H % s == 0
              and (H // s in (8, 16) or H // s >= REG_ROWS and H // s % 4 == 0)),
             None)
    if S is None:
        return None
    # rows per cluster: a power of two (a template argument), at most S so
    # that every (row, unit) pair has a gate thread
    R = min(1 << (min(B, ASYNC_MAX_ROWS) - 1).bit_length(), S)
    L = H // S
    reg_l = min(L, REG_ROWS)
    tail = 3 * (L - reg_l)
    floats = 2 * R * H + _round4(S * R * 3 * U) + _round4(R * U) + tail * U * S
    smem = 4 * floats
    if smem > SMEM_LIMIT - STATIC_SMEM:
        return None
    return GruPlan(C, U, S, R, U * S, 3 * reg_l, tail, smem)


def gru_plan(H: int, B: int, cluster: int | None = None) -> GruPlan | None:
    """The async kernel's partition at hidden size H and batch B, or None
    where it takes none (H past 512, H not a multiple of the cluster size,
    or a slice of Wh past the registers and 227 KiB of shared memory). By
    default the cluster size is 16, else 8 (an H that is a multiple of 8
    but not of 16)."""
    if cluster is not None and cluster not in ASYNC_CLUSTERS:
        return None
    for C in (cluster,) if cluster else ASYNC_CLUSTERS:
        plan = _async_plan(H, max(B, 1), C)
        if plan is not None:
            return plan
    return None


def gru_partition(H: int, plan: GruPlan):
    """What each thread of the async kernel sums, as the source computes it:
    ``[(rank, u, s, column of Wh, first row, rows in registers, rows in
    shared memory)]`` for every CTA ``rank``, thread (u, s) and each of its
    three columns."""
    U, S = plan.units, plan.segments
    L = H // S
    return [(rank, u, s, g * H + rank * U + u, s * L, plan.reg_weights // 3,
             plan.smem_weights // 3)
            for rank in range(plan.cluster) for s in range(S)
            for u in range(U) for g in range(3)]


# "general" (csrc/gru_recurrence_general.cu), mirrored: the source constants
GENERAL_MAX_HIDDEN = 1023  # kMaxH: past it Wh alone fills the JAX kernel's budget
GENERAL_MAX_CLUSTER = 16   # kMaxCluster
GENERAL_MAX_THREADS = 256  # kMaxThreads
GENERAL_MAX_ROWS = 8       # kMaxRows
CHUNK_ROWS = 8             # kChunkRows: rows of a column in one streamed chunk
RING_SLOTS = 2             # kRingSlots


class GeneralPlan(NamedTuple):
    """The general kernel's partition of one (H, B): ``cluster`` = min(16,
    H) CTAs per chunk of ``rows`` batch rows, CTA k owning a run of
    floor(H / C) or ceil(H / C) = ``units`` units; ``threads`` threads, of
    which the first ``units`` x ``segments`` are product threads: thread
    (u, s) sums rows [s L, (s + 1) L) (L = ``seg_rows``) of the r, z and n
    columns of unit u, ``reg_rows`` of them from registers, ``smem_rows``
    from shared memory, the last ``stream_rows`` streamed from L2 every
    step in chunks of :data:`CHUNK_ROWS`. ``smem_bytes`` is the CTA's
    dynamic shared memory."""
    cluster: int
    units: int
    segments: int
    rows: int
    threads: int
    seg_rows: int
    reg_rows: int
    smem_rows: int
    stream_rows: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _general_smem_floats(H, C, S, L, R, LR):
    """The source's ``make_plan``: dynamic shared memory in floats."""
    UM = _ceil(H, C)
    NP = UM * S
    LT = L - REG_ROWS - LR
    return (2 * R * S * L + _round4(S * R * 3 * UM) + R * _round4(UM)
            + 3 * LR * NP + (RING_SLOTS * 3 * CHUNK_ROWS * NP if LT else 0))


@functools.lru_cache(maxsize=4096)
def _general_plan(H: int, B: int) -> GeneralPlan | None:
    if H < 1 or H > GENERAL_MAX_HIDDEN:
        return None
    C = min(GENERAL_MAX_CLUSTER, H)
    UM = _ceil(H, C)
    # segments: as many as keep a segment's rows past the registers' kRegL
    S = max(1, min(GENERAL_MAX_THREADS // UM, H // REG_ROWS))
    L = max(REG_ROWS, _ceil(_ceil(H, S), CHUNK_ROWS) * CHUNK_ROWS)
    # rows per cluster: a power of two (a template argument) with a gate
    # thread for every (row, unit) pair
    R = min(1 << (min(B, GENERAL_MAX_ROWS) - 1).bit_length(),
            1 << ((GENERAL_MAX_THREADS // UM).bit_length() - 1))
    NP = UM * S
    cap = (SMEM_LIMIT - STATIC_SMEM) // 4
    LS = L - REG_ROWS
    if _general_smem_floats(H, C, S, L, R, LS) <= cap:
        LR = LS  # the whole slice resident
    else:  # the ring streams what the rest of shared memory does not hold
        free = cap - _general_smem_floats(H, C, S, L, R, 0)
        LR = free // (3 * NP) // CHUNK_ROWS * CHUNK_ROWS
        if LR < 0:
            return None
    threads = _ceil(max(NP, R * UM), 32) * 32
    return GeneralPlan(C, UM, S, R, threads, L, REG_ROWS, LR, LS - LR,
                       4 * _general_smem_floats(H, C, S, L, R, LR))


def general_plan(H: int, B: int) -> GeneralPlan | None:
    """The general kernel's partition at hidden size H and batch B, or None
    where it takes none (H outside 1 to 1023)."""
    return _general_plan(H, max(B, 1))


def general_partition(H: int, plan: GeneralPlan):
    """Who owns what in the general kernel, as the source computes it:
    ``[(rank, first unit, units)]`` for every CTA, and for every CTA
    ``rank`` and product thread (u, s) of a unit it owns
    ``[(rank, u, s, first row, rows in registers, rows in shared memory,
    rows streamed)]``, counting rows of Wh (below H) only."""
    C, S, L = plan.cluster, plan.segments, plan.seg_rows
    base, extra = divmod(H, C)
    runs = [(k, k * base + min(k, extra), base + (k < extra)) for k in range(C)]
    parts = []
    for rank, _, U in runs:
        for s in range(S):
            for u in range(U):
                k0 = s * L
                spans = (plan.reg_rows, plan.smem_rows, plan.stream_rows)
                counts, k = [], k0
                for n in spans:
                    counts.append(max(0, min(k + n, H) - k) if k < H else 0)
                    k += n
                parts.append((rank, u, s, k0, *counts))
    return runs, parts


# "grid" (csrc/gru_recurrence_grid.cu), mirrored: the source constants
GRID_CLUSTER = 16          # kCluster: CTAs per cluster
GRID_MAX_CTAS = 112        # kMaxCtas: CTAs of one launch, every chunk of rows
ROW_ALIGN = 4              # kRowAlign: a segment's rows are a multiple of it
COUNTER_STRIDE = 32        # kCounterStride: ints per chunk's counter


class GridPlan(NamedTuple):
    """The grid kernel's partition of one (H, B): for each of ``chunks``
    chunks of ``rows`` batch rows, ``clusters`` clusters of ``cluster``
    CTAs (``ctas`` = G in all), CTA k owning a run of floor(H / G) or
    ceil(H / G) = ``units`` units; ``threads`` threads, of which the first
    ``units`` x ``segments`` are product threads: thread (u, s) sums rows
    [s L, (s + 1) L) (L = ``seg_rows``) of the r, z and n columns of unit
    u, ``reg_rows`` of them from registers and the other ``smem_rows`` from
    shared memory, all loaded once. ``smem_bytes`` is the CTA's dynamic
    shared memory, ``workspace_words`` the 4-byte words of the zeroed
    workspace a launch needs (the chunks' counters and the exchanged h)."""
    cluster: int
    clusters: int
    ctas: int
    units: int
    segments: int
    rows: int
    chunks: int
    threads: int
    seg_rows: int
    reg_rows: int
    smem_rows: int
    smem_bytes: int
    workspace_words: int


def _grid_smem_floats(H, G, S, L, R):
    """The source's ``make_plan``: dynamic shared memory in floats."""
    UM = _ceil(H, G)
    return R * S * L + _round4(S * R * 3 * UM) + 3 * (L - REG_ROWS) * UM * S


@functools.lru_cache(maxsize=4096)
def _grid_plan(H: int, B: int) -> GridPlan | None:
    if H < 1 or H > GENERAL_MAX_HIDDEN:
        return None
    cap = SMEM_LIMIT // 4
    for N in range(1, GRID_MAX_CTAS // GRID_CLUSTER + 1):
        G = N * GRID_CLUSTER
        if G > H:
            return None
        UM = _ceil(H, G)
        S = max(1, min(GENERAL_MAX_THREADS // UM, H // REG_ROWS))
        L = max(REG_ROWS, _ceil(_ceil(H, S), ROW_ALIGN) * ROW_ALIGN)
        R = min(1 << (min(B, GENERAL_MAX_ROWS) - 1).bit_length(),
                1 << ((GENERAL_MAX_THREADS // UM).bit_length() - 1))
        chunks = _ceil(B, R)
        if G * chunks > GRID_MAX_CTAS:
            return None  # more CTAs would not all be resident at once
        floats = _grid_smem_floats(H, G, S, L, R)
        if floats <= cap:
            threads = _ceil(max(UM * S, R * UM), 32) * 32
            return GridPlan(GRID_CLUSTER, N, G, UM, S, R, chunks, threads, L,
                            REG_ROWS, L - REG_ROWS, 4 * floats,
                            COUNTER_STRIDE * chunks + 2 * B * _round4(H))
    return None


def grid_plan(H: int, B: int) -> GridPlan | None:
    """The grid kernel's partition at hidden size H and batch B: the fewest
    clusters whose CTAs hold Wh whole, or None where none do within
    :data:`GRID_MAX_CTAS` CTAs for all of B's chunks of rows (or where a
    CTA would own no unit: H below 16)."""
    return _grid_plan(H, max(B, 1))


def grid_partition(H: int, plan: GridPlan):
    """Who owns what in the grid kernel, as the source computes it:
    ``[(rank, first unit, units)]`` for every CTA of a chunk, and for every
    CTA ``rank`` and product thread (u, s) of a unit it owns ``[(rank, u,
    s, first row, rows in registers, rows in shared memory)]``, counting
    rows of Wh (below H) only."""
    G, S, L = plan.ctas, plan.segments, plan.seg_rows
    base, extra = divmod(H, G)
    runs = [(k, k * base + min(k, extra), base + (k < extra))
            for k in range(G)]
    parts = []
    for rank, _, U in runs:
        for s in range(S):
            k0, k1 = s * L, s * L + plan.reg_rows
            n_reg = max(0, min(k1, H) - k0)
            n_smem = max(0, min(k1 + plan.smem_rows, H) - k1)
            parts += [(rank, u, s, k0, n_reg, n_smem) for u in range(U)]
    return runs, parts


def gru_fits_smem(T: int, B: int, H: int) -> bool:
    """Whether a kernel of the card takes hidden size H: every H from 1 to
    1023 (the general kernel, ``general_plan``; the async kernel takes the
    multiples of 8 or 16 up to 512 of them, ``gru_plan``). T does not
    count: gates and outputs stream from device memory. B counts only up to
    the rows one cluster holds; further rows go to further clusters."""
    del T
    return general_plan(H, B) is not None


# Device ms measured by chip_smoke.py on an H100 80GB HBM3 at 700 W
# (PERF.md): barrier / async at 16 CTAs / async at 8 CTAs; the general
# kernel's own times at these and at wider or ragged H are in PERF.md.
#   T 128, B 4, H 256 (the 0102 encoder):      0.637 / 0.183 / 0.189
#   the same at /caption lengths 21/30/104/69: 0.630 / 0.150 / 0.156
#   T 128, B 32, H 256:                        1.059 / 0.263 / 0.309
#   T 128, B 4, H 128:                         0.268 / 0.129 / 0.138
#   T 1, B 4, H 256:                           0.028 / 0.0054 / 0.0056
#   T 128, B 4, H 512:                         -     / 0.374 / -
def gru_route(T: int, B: int, H: int) -> str:
    """The variant ``gru_recurrence`` launches by default: the async kernel
    wherever it takes H (the faster at every shape measured, above), with
    ``gru_plan``'s cluster size; else the grid kernel wherever the general
    one would stream part of Wh every step and ``grid_plan`` holds it whole;
    else the general kernel, whose launch raises past H 1023. The barrier
    kernel only where it is forced."""
    del T
    if gru_plan(H, B) is not None:
        return "async"
    general = general_plan(H, B)
    if general is not None and general.stream_rows > 0 \
            and grid_plan(H, B) is not None:
        return "grid"
    return "general"


# the JAX package's budget for its kernel's gates, outputs and weights
# (``_VMEM_LIMIT_BYTES``, tennis_tpu/ops/pallas/gru.py)
REFERENCE_BUDGET = 12 * 1024 * 1024


def reference_runs_kernel(T: int, B: int, H: int) -> bool:
    """Whether the JAX package runs its kernel at (T, B, H): its
    ``gru_fits_vmem``, the f32 gates, outputs, Wh and h within
    :data:`REFERENCE_BUDGET`. Never at H >= 1024, where Wh alone fills it."""
    return 4 * (T * B * 4 * H + 3 * H * H + B * H) <= REFERENCE_BUDGET


def gru_decode_route(T: int, B: int, H: int) -> str:
    """How a GRU layer inside ``ops.rnn.gru_decode()`` runs (T, B, H):
    ``"plain"``, the layer's plain differentiable recurrence, only where
    no kernel of the card takes the shape (:func:`gru_fits_smem`) and the
    JAX package runs its scan too (:func:`reference_runs_kernel` fails);
    else the variant :func:`gru_route` picks, which on the card launches.
    Every H from 1 to 1023 has a card kernel and the JAX package never runs
    its kernel at H >= 1024, so "plain" means H >= 1024. It reads the
    shapes alone, before any launch."""
    if not gru_fits_smem(T, B, H) and not reference_runs_kernel(T, B, H):
        return "plain"
    return gru_route(T, B, H)


def gru_recurrence_reference(gates_x, h0, wh, bh, valid_length=None):
    """Plain PyTorch version of the kernel: a loop over T in f32.

    gates_x (T, B, 3H) = x.Wx + bx; h0 (B, H); wh (H, 3H); bh (3H,); gate
    order r, z, n. Past ``valid_length`` (B,) the carry freezes and outputs
    are zero. Returns (ys (T, B, H), h_final (B, H)).
    """
    T, B, _ = gates_x.shape
    H = h0.shape[-1]
    gates_x = gates_x.float()
    wh, bh = wh.float(), bh.float()
    if valid_length is None:
        valid_length = torch.full((B,), T, dtype=torch.int32,
                                  device=gates_x.device)
    h = h0.float()
    ys = []
    for t in range(T):
        gh = h @ wh + bh
        xr, xz, xn = gates_x[t].split(H, dim=-1)
        hr, hz, hn = gh.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        new_h = (1.0 - z) * n + z * h
        alive = (t < valid_length)[:, None]
        h = torch.where(alive, new_h, h)
        ys.append(torch.where(alive, new_h, torch.zeros_like(new_h)))
    return torch.stack(ys), h


def _check_kernel_args(gates_x, h0, wh, bh, valid_length):
    for name, t in (("gates_x", gates_x), ("h0", h0), ("wh", wh), ("bh", bh)):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_recurrence kernel takes f32 {name}, "
                            f"got {t.dtype}")
        if t.device != gates_x.device:
            raise ValueError(f"gru_recurrence kernel: {name} must be on "
                             f"{gates_x.device}")
    if gates_x.dim() != 3:
        raise ValueError("gru_recurrence kernel takes gates_x (T, B, 3H)")
    T, B, G = gates_x.shape
    H = h0.shape[-1]
    if (tuple(h0.shape) != (B, H) or G != 3 * H or tuple(wh.shape) != (H, G)
            or tuple(bh.shape) != (G,) or tuple(valid_length.shape) != (B,)):
        raise ValueError(
            f"gru_recurrence kernel: shapes gates_x {tuple(gates_x.shape)}, "
            f"h0 {tuple(h0.shape)}, wh {tuple(wh.shape)}, bh "
            f"{tuple(bh.shape)}, valid_length {tuple(valid_length.shape)} "
            f"do not fit (T, B, 3H), (B, H), (H, 3H), (3H,), (B,)")
    if gates_x.stride(2) != 1 or not h0.is_contiguous() or \
            not bh.is_contiguous():
        raise ValueError("gru_recurrence kernel takes gates_x with a unit "
                         "stride on the gate axis and contiguous h0 and bh")


def _launcher(variant):
    from tennis_torch.ops._build import load_library

    name = {"barrier": "gru_recurrence", "async": "gru_recurrence_async",
            "general": "gru_recurrence_general",
            "grid": "gru_recurrence_grid"}[variant]
    fn = getattr(load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # ... T, B, H, then S, R (barrier), C, S, R (async), C, S, L, R, LR
        # (general) or G, S, L, R and the workspace (grid); the stream
        n_int = {"barrier": 5, "async": 6, "general": 8, "grid": 7}[variant]
        fn.argtypes = [p, ll, ll, p, p, ll, ll, p, p, p, ll, ll, p] + \
            [i] * n_int + [p] * (2 if variant == "grid" else 1)
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("tennis_torch::gru_recurrence", mutates_args=(),
                         device_types="cpu")
def gru_recurrence_op(gates_x: torch.Tensor, h0: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor,
                      valid_length: torch.Tensor, variant: str,
                      cluster: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``tennis_torch::gru_recurrence``: the recurrence as a custom op, so
    that ``torch.export`` keeps it as one node naming its kernel. Returns a
    contiguous batch-major ``ys`` (B, T, H) and ``h_final`` (B, H), new
    tensors (an op's output may alias no input). ``variant`` is
    :func:`gru_route`'s, ``cluster`` the async kernel's cluster size (0:
    :func:`gru_plan`'s; the general kernel takes only its own, min(16,
    H), the grid kernel only 16). On the CPU it runs
    :func:`gru_recurrence_reference`, whatever the variant."""
    ys, h_final = gru_recurrence_reference(gates_x, h0, wh, bh, valid_length)
    return ys.transpose(0, 1).contiguous(), h_final


@gru_recurrence_op.register_kernel("cuda")
def _gru_recurrence_cuda(gates_x, h0, wh, bh, valid_length, variant, cluster):
    """The launch: the kernel ``variant`` names, or a raise; no fallback."""
    _check_kernel_args(gates_x, h0, wh, bh, valid_length)
    T, B, G = gates_x.shape
    H = G // 3
    if variant == "async":
        plan = gru_plan(H, B, cluster or None)
        if plan is None:
            raise ValueError(
                f"gru_recurrence async kernel: hidden size {H} is beyond its "
                f"register and shared-memory budget (H up to {MAX_HIDDEN}, a "
                f"multiple of the cluster size {cluster or ASYNC_CLUSTERS}); "
                f"the general kernel takes every H up to {GENERAL_MAX_HIDDEN}")
        partition = (plan.cluster, plan.segments, plan.rows)
    elif variant == "general":
        plan = general_plan(H, B)
        if plan is None:
            raise ValueError(
                f"gru_recurrence general kernel: hidden size {H} is beyond "
                f"its register and shared-memory budget (H from 1 to "
                f"{GENERAL_MAX_HIDDEN}; at H >= 1024 the JAX package runs "
                f"its scan, and gru_decode_route the plain recurrence)")
        if cluster not in (0, plan.cluster):
            raise ValueError(f"gru_recurrence general kernel: H {H} takes "
                             f"clusters of {plan.cluster}, not {cluster}")
        if wh.stride(0) == 1 and (wh.stride(1) % 4 or wh.data_ptr() % 16):
            # a transposed weight whose columns the kernel cannot copy 16
            # bytes at a time: row-major, so a warp's copies read adjacent
            # columns (the card measured 2x at H 737)
            wh = wh.contiguous()
        partition = (plan.cluster, plan.segments, plan.seg_rows, plan.rows,
                     plan.smem_rows)
    elif variant == "grid":
        plan = grid_plan(H, B)
        if plan is None:
            raise ValueError(
                f"gru_recurrence grid kernel: no grid holds Wh of hidden size "
                f"{H} at batch {B} (H from {GRID_CLUSTER} to "
                f"{GENERAL_MAX_HIDDEN}, within {GRID_MAX_CTAS} resident CTAs "
                f"for every chunk of rows); the general kernel takes it")
        if cluster not in (0, plan.cluster):
            raise ValueError(f"gru_recurrence grid kernel: H {H} takes "
                             f"clusters of {plan.cluster}, not {cluster}")
        if wh.stride(1) != 1:
            # Wh is read once, before step 0: row-major, a warp's loads
            # read adjacent columns
            wh = wh.contiguous()
        # the chunks' counters and the exchanged h, zero for every launch
        workspace = torch.zeros(plan.workspace_words, dtype=torch.int32,
                                device=gates_x.device)
        partition = (plan.ctas, plan.segments, plan.seg_rows, plan.rows,
                     workspace.data_ptr())
    else:
        if not barrier_fits(H, B):
            need = _smem_bytes(H, *_split(H, B)) if H % CLUSTER == 0 else None
            raise ValueError(
                f"gru_recurrence barrier kernel: hidden size {H} is beyond "
                f"its shared-memory budget (H a multiple of {CLUSTER}, and "
                f"{3 * H // CLUSTER} columns of Wh plus the h buffers in "
                f"{SMEM_LIMIT} B per CTA; this H needs {need} B)")
        partition = _split(H, B)
    out = torch.empty((B, T, H), dtype=torch.float32, device=gates_x.device)
    ys = out.transpose(0, 1)
    h_final = torch.empty((B, H), dtype=torch.float32, device=gates_x.device)
    valid_length = valid_length.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    with torch.cuda.device(gates_x.device):
        err = _launcher(variant)(
            gates_x.data_ptr(), gates_x.stride(0), gates_x.stride(1),
            h0.data_ptr(), wh.data_ptr(), wh.stride(0), wh.stride(1),
            bh.data_ptr(), valid_length.data_ptr(),
            ys.data_ptr(), ys.stride(0), ys.stride(1), h_final.data_ptr(),
            T, B, H, *partition, stream)
    if err:
        raise RuntimeError(f"gru_recurrence {variant} kernel launch failed: "
                           f"CUDA error {err}")
    gru_recurrence.launches += 1
    gru_recurrence.variant_launches[variant] += 1
    return out, h_final


@gru_recurrence_op.register_fake
def _(gates_x, h0, wh, bh, valid_length, variant, cluster):
    T, B, G = gates_x.shape
    return (gates_x.new_empty((B, T, G // 3), dtype=torch.float32),
            gates_x.new_empty((B, G // 3), dtype=torch.float32))


def gru_recurrence(gates_x, h0, wh, bh, valid_length=None,
                   variant: str | None = None, cluster: int | None = None):
    """GRU recurrence over precomputed input gates (see
    :func:`gru_recurrence_reference` for the function), through
    :func:`gru_recurrence_op`: CUDA tensors go through the kernel that
    ``variant`` names (``"async"``, ``"general"``, ``"grid"`` or
    ``"barrier"``; by default :func:`gru_route`'s choice, resolved here
    from the static shapes), the async one with ``cluster`` CTAs per chunk
    of rows (by default :func:`gru_plan`'s); CPU tensors through the plain
    version, whatever the variant. On the card a gradient may not be required: the
    kernels are forward-only.

    Returns (ys (T, B, H), h_final (B, H)) f32; ``ys`` is a (T, B, H) view
    of a batch-major (B, T, H) buffer, so ``ys.transpose(0, 1)`` is
    contiguous.
    """
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"gru_recurrence variant must be one of {VARIANTS}, "
                         f"not {variant!r}")
    if gates_x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_recurrence runs on cuda or cpu, not "
                         f"{gates_x.device}")
    T, B, G = gates_x.shape
    if gates_x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (gates_x, h0, wh, bh)):
        raise RuntimeError("gru_recurrence kernel is forward-only: run it "
                           "under torch.inference_mode() or torch.no_grad()")
    if valid_length is None:
        valid_length = torch.full((B,), T, dtype=torch.int32,
                                  device=gates_x.device)
    valid_length = valid_length.to(device=gates_x.device, dtype=torch.int32)
    variant = variant or gru_route(T, B, G // 3)
    ys, h_final = gru_recurrence_op(gates_x, h0, wh, bh, valid_length,
                                    variant, cluster or 0)
    return ys.transpose(0, 1), h_final


# kernel launches, so a run can show it took a kernel, and which one
gru_recurrence.launches = 0
gru_recurrence.variant_launches = dict.fromkeys(VARIANTS, 0)
# layers that gru_decode_route sent to the plain recurrence, on any device
gru_recurrence.plain_routed = 0


def gru_sequence(x, h0, wx, wh, bx, bh, valid_length=None):
    """Full GRU over (T, B, C) inputs: one sequence-wide input projection
    (a plain matmul), then :func:`gru_recurrence`. Parameter layout as in
    ``GRUCell`` (``wx`` (C, 3H), ``wh`` (H, 3H)). Returns (ys (T, B, H),
    h_final (B, H))."""
    gates_x = torch.matmul(x.float(), wx.float()) + bx.float()
    return gru_recurrence(gates_x, h0, wh, bh, valid_length)
