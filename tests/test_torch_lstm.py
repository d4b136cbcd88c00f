"""GPU port: the BiLSTM recurrence and `bilstm` vs the JAX Pallas kernel
(interpret mode on the CPU), and the CUDA kernel vs its plain version on
a card."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.nn import lstm as jlstm
from vocal_remover_tpu.nn.lstm_pallas import _run_recurrence, bilstm_pallas
from vocal_remover_tpu_torch.nn import lstm as tlstm
from vocal_remover_tpu_torch.nn import lstm_kernel

torch.set_num_threads(1)


def _inputs(t_len, two_n, hidden, seed):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((t_len, two_n, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((2, hidden, 4 * hidden))
            / np.sqrt(hidden)).astype(np.float32)
    return xg, w_hh


@pytest.mark.parametrize("t_len,two_n,hidden", [(16, 8, 16), (33, 4, 32),
                                                (5, 2, 160)])
def test_recurrence_plain_matches_pallas(t_len, two_n, hidden):
    xg, w_hh = _inputs(t_len, two_n, hidden, seed=t_len)
    ref = np.asarray(_run_recurrence(xg, w_hh, interpret=True))
    before = lstm_kernel.launches
    out = lstm_kernel.recurrence(torch.from_numpy(xg), torch.from_numpy(w_hh))
    assert lstm_kernel.launches == before  # CPU tensors: plain version
    assert out.shape == (t_len, two_n, hidden)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("t_len,n,input_size,hidden", [
    (16, 4, 32, 16),
    (33, 2, 64, 32),
    (5, 1, 24, 160),  # H > 128: the kernel's wide path on the card
])
def test_bilstm_matches_pallas(t_len, n, input_size, hidden):
    params = jlstm.init_bilstm(jax.random.PRNGKey(0), input_size, hidden)
    x = np.random.default_rng(1).standard_normal(
        (t_len, n, input_size)).astype(np.float32)
    ref = np.asarray(bilstm_pallas(params, x))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), params)
    out = tlstm.bilstm(tparams, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (t_len, n, 2 * hidden)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_bilstm_module_uses_torch_layout():
    """BiLSTM's parameters are nn.LSTM's (4H, In) layout and names."""
    mod = tlstm.BiLSTM(12, 8)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    names = {n: tuple(p.shape) for n, p in mod.named_parameters()}
    ref = torch.nn.LSTM(12, 8, bidirectional=True)
    assert names == {n: tuple(p.shape) for n, p in ref.named_parameters()}
    ref.load_state_dict(mod.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (9, 3, 12)).astype(np.float32))
    with torch.no_grad():
        want, _ = ref(x)
        got = mod(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("xg_shape,w_shape,dtype,error", [
    ((4, 6, 32), (2, 8, 32), torch.float64, TypeError),
    ((4, 6, 32), (2, 4, 32), torch.float32, ValueError),
    ((4, 5, 32), (2, 8, 32), torch.float32, ValueError),
    ((6, 32), (2, 8, 32), torch.float32, ValueError),
])
def test_recurrence_rejects_bad_inputs(xg_shape, w_shape, dtype, error):
    with pytest.raises(error):
        lstm_kernel.recurrence(torch.zeros(xg_shape, dtype=dtype),
                               torch.zeros(w_shape, dtype=dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,two_n,hidden", [
    (128, 8, 64), (128, 8, 32), (37, 10, 32), (37, 6, 100), (5, 2, 1),
    (128, 8, 256), (37, 6, 200), (9, 4, 201), (2, 2, 9700),
])
def test_kernel_matches_plain_on_card(cuda_device, t_len, two_n, hidden):
    """The flagship launches (H = 64, 32), the ragged case, a hidden size
    past the register-resident weights (H = 100), H = 1, and the wide
    path past 128: H = 256, 200, 201 (rows of w_cols not whole float4s)
    and 9700 (the state in device scratch, not shared memory)."""
    xg, w_hh = _inputs(t_len, two_n, hidden, seed=3)
    xg_d = torch.from_numpy(xg).to(cuda_device)
    w_d = torch.from_numpy(w_hh).to(cuda_device)
    before = lstm_kernel.launches
    out = lstm_kernel.recurrence(xg_d, w_d)
    torch.cuda.synchronize()
    assert lstm_kernel.launches == before + 1
    ref = lstm_kernel.recurrence_plain(xg_d, w_d)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5)


def test_relayout_round_trip():
    """The kernel's weight layout is a transpose: undone, it gives back
    w_hh exactly, and it is torch's weight_hh_l0 stacked."""
    _, w_hh = _inputs(3, 4, 24, seed=1)
    w = torch.from_numpy(w_hh)
    w_cols = lstm_kernel.relayout(w)
    assert w_cols.shape == (2, 96, 24) and w_cols.is_contiguous()
    assert torch.equal(lstm_kernel.undo_relayout(w_cols), w)
    assert torch.equal(w_cols[1], w[1].t())


@pytest.mark.parametrize("t_len,two_n,hidden", [(16, 8, 16), (37, 10, 32)])
def test_recurrence_cols_plain_matches_pallas(t_len, two_n, hidden):
    """The plain recurrence through the re-laid weights matches
    `recurrence_plain` exactly and the JAX kernel in interpret mode."""
    xg, w_hh = _inputs(t_len, two_n, hidden, seed=t_len + 1)
    ref = np.asarray(_run_recurrence(xg, w_hh, interpret=True))
    w = torch.from_numpy(w_hh)
    before = lstm_kernel.launches
    out = lstm_kernel.recurrence_cols(torch.from_numpy(xg),
                                      lstm_kernel.relayout(w))
    assert lstm_kernel.launches == before
    assert torch.equal(out, lstm_kernel.recurrence_plain(
        torch.from_numpy(xg), w))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_recurrence_cols_rejects_the_other_layout():
    xg, w_hh = _inputs(4, 2, 8, seed=0)
    with pytest.raises(ValueError, match="w_cols"):
        lstm_kernel.recurrence_cols(torch.from_numpy(xg),
                                    torch.from_numpy(w_hh))
