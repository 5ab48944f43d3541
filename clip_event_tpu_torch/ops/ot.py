"""Inexact proximal-point optimal transport (IPOT) for the graph-alignment
loss (counterpart of `clip_event_tpu/ops/ot.py` and `ops/ot_pallas.py`).

The batched cosine cost between text-entity and image-object embeddings, a
fixed-iteration IPOT solver whose transport plan is a constant (computed
under `torch.no_grad()` from the detached cost), and distance
trace(C·T), whose gradient flows through the cost only. `safe=True` clamps
the node counts to ≥ 1 and zeroes the distance of a graph with no real
nodes (the reference divides by zero there).

The solver comes in two forms: `ipot`, plain PyTorch (a Python loop of
`iterations × k` batched updates, fp32), and `ipot_kernel`, which on a
CUDA tensor launches K3, the hand-written kernel of `csrc/ipot.cu` (one
launch for the whole solve), raises if the kernel cannot take the input,
and on a CPU tensor runs `ipot`. `use_pallas` (the config key
`use_pallas_ot`) picks between them: True means `ipot_kernel`, False
means `ipot`, "auto" means `ipot_kernel` when both node axes reach
`AUTO_MIN_NODES`.
"""

from __future__ import annotations

import ctypes

import torch

from clip_event_tpu_torch.ops import _build

MASK_BIG = 1e4  # reference model_ot.py:52-53
KERNEL = "ipot"
MAX_NODES = 128  # the kernel holds two [N, M] fp32 matrices in shared memory
# "auto" takes the kernel from this many nodes on both axes. On an NVIDIA
# H100 80GB HBM3 (700 W) the kernel beat the plain solver at every shape
# chip_smoke.py times, from finetune_ot's (64, 16, 7) (0.08 ms against
# 9 ms) to (256, 128, 128) (2.2 ms against 13 ms) (PERF.md §6), so "auto"
# means the kernel for any non-empty graph on the card. The TPU's threshold
# of 32 nodes (JAX `ot.py:164-165`) was measured there and does not apply.
AUTO_MIN_NODES = 1


def cost_matrix_cosine(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pairwise cosine distance: [B, M, D] × [B, N, D] → [B, M, N]; the
    denominator is max(norm, eps), as `F.normalize(p=2, eps=1e-5)`."""

    def norm(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)

    return 1.0 - torch.matmul(norm(x), norm(y).transpose(1, 2))


def ipot(
    C: torch.Tensor,
    x_len: torch.Tensor,
    x_pad: torch.Tensor,
    y_len: torch.Tensor,
    y_pad: torch.Tensor,
    joint_pad: torch.Tensor,
    beta: float,
    iterations: int,
    k: int,
) -> torch.Tensor:
    """The plain IPOT solver. C: [B, M, N]; pads True at padded nodes;
    returns the plan T: [B, N, M] (transposed, as in the reference), fp32."""
    B, M, N = C.shape
    C = C.float()
    x_len = x_len.float()
    y_len = y_len.float()
    joint_pad_t = joint_pad.transpose(1, 2)  # [B, N, M]
    zero = torch.zeros((), dtype=torch.float32, device=C.device)
    A = torch.where(joint_pad_t, zero, torch.exp(-C.transpose(1, 2) / beta))
    T = torch.where(joint_pad_t, zero, torch.ones_like(A))
    sigma = torch.where(x_pad, zero, 1.0 / x_len[:, None])  # [B, M]
    x_mask = torch.where(x_pad, MASK_BIG, 0.0)  # [B, M]
    y_mask = torch.where(y_pad, MASK_BIG, 0.0)  # [B, N]
    x_len_b, y_len_b = x_len[:, None], y_len[:, None]
    for _ in range(iterations):
        Q = A * T
        for _ in range(k):
            q_sig = torch.bmm(Q, sigma[:, :, None])[:, :, 0]  # [B, N]
            delta = 1.0 / (y_len_b * q_sig + y_mask)
            d_q = torch.bmm(delta[:, None, :], Q)[:, 0, :]  # [B, M]
            sigma = 1.0 / (x_len_b * d_q + x_mask)
        T = delta[:, :, None] * Q * sigma[:, None, :]
    return torch.where(joint_pad_t, zero, T)


def _check_kernel_input(cost, x_len, x_pad, y_len, y_pad):
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, M, N], got {tuple(cost.shape)}")
    B, M, N = cost.shape
    if not (1 <= M <= MAX_NODES and 1 <= N <= MAX_NODES):
        raise ValueError(
            f"IPOT kernel takes 1 <= M, N <= {MAX_NODES} nodes (max_entities, max_objects), "
            f"got M={M} N={N}"
        )
    if B < 1:
        raise ValueError("IPOT kernel needs B >= 1")
    for name, t, shape in (("x_len", x_len, (B,)), ("x_pad", x_pad, (B, M)),
                           ("y_len", y_len, (B,)), ("y_pad", y_pad, (B, N))):
        if tuple(t.shape) != shape or t.device != cost.device:
            raise ValueError(f"{name} must be {shape} on {cost.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if cost.device.type != "cuda":
        raise ValueError(f"IPOT kernel needs a CUDA tensor, got {cost.device}")


def ipot_kernel(
    cost: torch.Tensor,
    x_len: torch.Tensor,
    x_pad: torch.Tensor,
    y_len: torch.Tensor,
    y_pad: torch.Tensor,
    beta: float = 0.5,
    iterations: int = 50,
    k: int = 1,
) -> torch.Tensor:
    """K3, the drop-in for `ipot` (JAX `ipot_pallas`): cost [B, M, N] →
    plan [B, N, M] fp32, pads True at padded nodes. A CPU tensor runs the
    plain `ipot`; any other device must be a CUDA tensor the kernel takes
    (M, N <= 128), else this raises."""
    if cost.device.type == "cpu":
        joint_pad = x_pad[:, :, None] | y_pad[:, None, :]
        return ipot(cost, x_len, x_pad, y_len, y_pad, joint_pad, beta, iterations, k)
    _check_kernel_input(cost, x_len, x_pad, y_len, y_pad)
    B, M, N = cost.shape
    args = [t.float().contiguous() for t in (cost, x_pad, y_pad, x_len, y_len)]
    plan = torch.empty((B, N, M), dtype=torch.float32, device=cost.device)
    lib = _build.load(KERNEL)
    fn = lib.clip_ipot
    if fn.argtypes is None:
        _P, _I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [_P] * 6 + [_I, _I, _I, ctypes.c_float, _I, _I, _P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        code = fn(*(t.data_ptr() for t in args), plan.data_ptr(), B, M, N, float(beta),
                  int(iterations), int(k), stream)
    _build.check(lib, code, "ipot launch")
    ipot_kernel.launches += 1
    return plan


# kernel launches since the last reset (chip_smoke.py reads and resets it)
ipot_kernel.launches = 0


def optimal_transport_dist(
    txt_emb: torch.Tensor,
    img_emb: torch.Tensor,
    txt_pad: torch.Tensor,
    img_pad: torch.Tensor,
    beta: float = 0.5,
    iterations: int = 50,
    k: int = 1,
    safe: bool = False,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Batched OT distance (reference `model_ot.py:66-84`): txt_emb
    [B, M, D], img_emb [B, N, D], pads True at padded nodes → [B] fp32.
    The plan is a constant; the gradient flows through the cost only."""
    txt_pad = txt_pad.bool()
    img_pad = img_pad.bool()
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = cost_matrix_cosine(txt_emb.float(), img_emb.float())
    cost = cost.masked_fill(joint_pad, 0.0)

    txt_len = (txt_pad.shape[1] - txt_pad.sum(dim=1)).float()
    img_len = (img_pad.shape[1] - img_pad.sum(dim=1)).float()
    if safe:
        txt_len = txt_len.clamp_min(1.0)
        img_len = img_len.clamp_min(1.0)

    with torch.no_grad():
        c = cost.detach()
        if use_pallas:
            T = ipot_kernel(c, txt_len, txt_pad, img_len, img_pad, beta, iterations, k)
        else:
            T = ipot(c, txt_len, txt_pad, img_len, img_pad, joint_pad, beta, iterations, k)

    # trace(C @ T): C [B, M, N], T [B, N, M] → Σ_mn C[m, n]·T[n, m]
    distance = (cost * T.transpose(1, 2)).sum(dim=(1, 2))
    if safe:
        has_nodes = (~txt_pad).any(dim=1) & (~img_pad).any(dim=1)
        distance = torch.where(has_nodes, distance, torch.zeros_like(distance))
    return distance


def alignment_loss(
    entity_emb: torch.Tensor,
    object_emb: torch.Tensor,
    entity_mask: torch.Tensor,
    object_mask: torch.Tensor,
    scale: float = 0.01,
    safe: bool = True,
    use_pallas=False,
) -> torch.Tensor:
    """`CriterionAlignment` (reference `model_clip.py:664-715`): entity_emb
    [B, M, E], object_emb [B, N, E] with the whole image at slot 0 (dropped),
    masks 1 at real nodes → scalar `scale · Σ_b ot_dist_b`.

    use_pallas: True, False or "auto" (the kernel on a CUDA tensor when both
    node axes reach `AUTO_MIN_NODES`); on a CPU tensor every setting runs
    the plain solver."""
    img_nodes = object_emb[:, 1:]
    if use_pallas == "auto":
        use_pallas = (
            entity_emb.device.type == "cuda"
            and min(entity_emb.shape[1], img_nodes.shape[1]) >= AUTO_MIN_NODES
        )
    txt_pad = entity_mask == 0
    img_pad = object_mask[:, 1:] == 0
    dist = optimal_transport_dist(
        entity_emb.float(), img_nodes.float(), txt_pad, img_pad, safe=safe,
        use_pallas=bool(use_pallas),
    )
    return scale * dist.sum()
