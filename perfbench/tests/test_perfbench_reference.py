"""The plain reference's own pieces against their definitions: the scan in
closed-form chunks against the recurrence stepped one position at a time,
forward and backward, and an MoE layer's shares of the experts summing to
the whole layer."""
import torch

from perfbench.reference import lm


def _stepped(x, dt, A, Bm, Cm):
    """y_t = C_t . h_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, one
    position at a time."""
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=x.dtype)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, Cm[:, t]))
    return torch.stack(ys, 1)


def _scan_inputs(dtype, S=37):
    g = torch.Generator().manual_seed(0)
    B, c, N = 2, 5, 4
    x = torch.randn(B, S, c, dtype=dtype, generator=g)
    dt = torch.rand(B, S, c, dtype=dtype, generator=g) * 0.3
    A = -torch.arange(1, N + 1, dtype=dtype).expand(c, N) \
        * (1 + torch.rand(c, N, dtype=dtype, generator=g))
    Bm = torch.randn(B, S, N, dtype=dtype, generator=g)
    Cm = torch.randn(B, S, N, dtype=dtype, generator=g)
    return [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]


def test_chunked_scan_is_the_recurrence():
    """37 positions: two whole chunks of 16 and a padded one."""
    args = _scan_inputs(torch.float64)
    y1, y2 = lm._Scan.apply(*args), _stepped(*args)
    torch.testing.assert_close(y1, y2, rtol=1e-12, atol=1e-12)
    gy = torch.randn_like(y1)
    g1 = torch.autograd.grad(y1, args, gy)
    g2 = torch.autograd.grad(y2, args, gy)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_scan_backward_passes_gradcheck():
    args = _scan_inputs(torch.float64, S=19)
    assert torch.autograd.gradcheck(lm._Scan.apply, args)


def test_expert_shares_sum_to_the_layer():
    """Four shares of 4 experts each, every share its own experts' part for
    the tokens routed to them: their sum is the layer over all 16."""
    g = torch.Generator().manual_seed(1)
    D, F, E = 32, 48, 16
    cfg = {"n_experts": E, "top_k": 4, "capacity_factor": 1.25,
           "aux_loss": 0.01, "router_z_loss": 0.001}
    p = {"router": torch.randn(D, E, generator=g) * 0.2,
         "moe_wg": torch.randn(E, D, F, generator=g) * 0.1,
         "moe_wu": torch.randn(E, D, F, generator=g) * 0.1,
         "moe_wd": torch.randn(E, F, D, generator=g) * 0.1}
    h = torch.randn(2, 24, D, generator=g)
    whole, aux = lm.moe_block(p, h, cfg, "fp32", None)
    parts = []
    for r in range(4):
        share = {k: (v[4 * r:4 * r + 4] if k.startswith("moe_") else v)
                 for k, v in p.items()}
        y, a = lm.moe_block(share, h, cfg, "fp32", (None, 4 * r),
                            exchange=False)
        parts.append(y)
        torch.testing.assert_close(a, aux)
    torch.testing.assert_close(sum(parts), whole, rtol=1e-6, atol=1e-6)
