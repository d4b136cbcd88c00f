"""GPU port, training slice: the port's `Trainer` against the JAX
package's on JAX's tiny configuration (same weights, same batches): an
Adam trajectory with gradient accumulation and a leftover flush in
float64, validation, the plateau scheduler; and, port against port,
resume, staging and what the trainer refuses."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.train.plateau import ReduceLROnPlateau as JPlateau
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert, serving
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint
from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
from vocal_remover_tpu_torch.train.step import Trainer

from torch_port_helpers import float64_mode, perturb_bn  # noqa: F401

torch.set_num_threads(1)

TINY = (64, 32, 4, 8)


@pytest.fixture(scope="module")
def weights():
    """JAX init (float32) with BN perturbed."""
    jmod = JCascadedNet(*TINY)
    return perturb_bn(jax.jit(jmod.init)(jax.random.PRNGKey(21)),
                      np.random.default_rng(21))


def batches(n, dtype, seed=22, sizes=None):
    """n (X, y) magnitude batches of (2, 2, 33, 160) (or sizes[i])."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = sizes[i] if sizes else 2
        X = np.abs(rng.standard_normal((b, 2, 33, 160))).astype(dtype)
        y = (X * rng.uniform(0.0, 1.0, X.shape)).astype(dtype)
        out.append((X, y))
    return out


def port_model(v, dtype=torch.float32):
    return convert.from_jax_variables(CascadedNet(*TINY), v).to(dtype)


def flat_variables(tree):
    return {k: np.asarray(a, np.float64)
            for k, a in convert._flatten(tree).items()}


def test_adam_trajectory_with_accumulation_matches_jax(weights, float64_mode):
    """accumulation_steps 2: epoch 1 of three microbatches (an Adam step
    after the second, the third flushed), set_learning_rate, epoch 2 of
    one microbatch (flushed): three Adam steps, the last a leftover
    flush. Parameters and BatchNorm statistics within 1e-8 of JAX's,
    epoch losses within 1e-10 relative."""
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), weights)
    data = batches(4, np.float64)
    jt = JTrainer(JCascadedNet(*TINY), v, learning_rate=1e-3,
                  accumulation_steps=2, dropout=False)
    model = port_model(v, torch.float64)
    trainer = Trainer(model, learning_rate=1e-3, accumulation_steps=2,
                      dropout=False, device="cpu")
    jl1, l1 = jt.train_epoch(data[:3]), trainer.train_epoch(data[:3])
    jt.set_learning_rate(5e-4)
    trainer.set_learning_rate(5e-4)
    assert trainer.learning_rate == 5e-4
    jl2, l2 = jt.train_epoch(data[3:]), trainer.train_epoch(data[3:])
    for a, b in ((l1, jl1), (l2, jl2)):
        assert abs(a - b) <= 1e-10 * abs(b)
    assert all(s["step"] == 3 for s in trainer.optimizer.state.values())
    want = flat_variables(jt.variables)
    have = flat_variables(convert.to_jax_variables(model))
    assert set(have) == set(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=1e-8,
                                   err_msg=k)
        moved += not np.array_equal(want[k], flat_variables(v)[k])
    assert moved > 100  # the steps changed weights and statistics


def test_validate_epoch_matches_jax(weights):
    data = batches(3, np.float32, seed=23, sizes=[2, 2, 1])
    jt = JTrainer(JCascadedNet(*TINY), weights, learning_rate=1e-3)
    trainer = Trainer(port_model(weights), learning_rate=1e-3, device="cpu")
    want = jt.validate_epoch(data)
    got = trainer.validate_epoch(data)
    assert abs(got - want) <= 1e-5 * want
    assert not trainer.model.training


def test_train_epoch_is_the_per_sample_mean_and_stages_bf16(weights):
    """The epoch loss weighs each batch by its length (learning rate 0:
    the weights stay, so each batch's loss is its compute_grads loss);
    bf16 staging is the loss of the bf16-rounded batch in float32."""
    data = batches(2, np.float32, seed=24, sizes=[2, 1])
    t32 = Trainer(port_model(weights), 0.0, dropout=False, device="cpu")
    l0, _ = t32.compute_grads(*data[0])
    l1, _ = t32.compute_grads(*data[1])
    got = t32.train_epoch(data)
    assert abs(got - (2 * l0 + l1) / 3) <= 1e-6 * got
    tb = Trainer(port_model(weights), 0.0, dropout=False,
                 transfer_dtype=torch.bfloat16, device="cpu")
    lb, _ = tb.compute_grads(*data[0])
    rounded = [torch.from_numpy(a).bfloat16().float().numpy()
               for a in data[0]]
    lr_, _ = Trainer(port_model(weights), 0.0, dropout=False,
                     device="cpu").compute_grads(*rounded)
    assert lb == lr_ and lb != l0


def test_resume_equals_an_uninterrupted_run(weights, tmp_path):
    """Two epochs straight == one epoch, save, a fresh trainer resumed
    from the file, one more epoch: the loss log, the weights and BN
    statistics, and Adam's state (dropout on: the step counter carries
    the dropout stream)."""
    data = [batches(2, np.float32, seed=s) for s in (25, 26)]

    def fresh():
        return (Trainer(port_model(weights), 1e-3, seed=5, device="cpu"),
                ReduceLROnPlateau(lr=1e-3, patience=0, factor=0.5))

    straight, sched = fresh()
    log = []
    for e in range(2):
        log.append(straight.train_epoch(data[e]))
        straight.set_learning_rate(sched.step(log[-1]))

    first, sched1 = fresh()
    log1 = [first.train_epoch(data[0])]
    first.set_learning_rate(sched1.step(log1[-1]))
    path = str(tmp_path / checkpoint.STATE_NAME)
    checkpoint.save_train_state(path, first, sched1, 0, log1[-1])
    resumed, sched2 = fresh()
    epoch, best = checkpoint.load_train_state(path, resumed, sched2)
    assert (epoch, best) == (0, log1[-1])
    assert resumed.learning_rate == first.learning_rate
    log1.append(resumed.train_epoch(data[1]))
    resumed.set_learning_rate(sched2.step(log1[-1]))

    assert log1 == log
    assert sched2.state_dict() == sched.state_dict()
    for k, t in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], t), k
    sa, sb = (t.optimizer.state_dict() for t in (straight, resumed))
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, t in st.items():
            assert torch.equal(sb["state"][i][k], t), (i, k)


def test_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.899999, 0.92, 0.93, 0.5, 0.6,
              0.7, 0.8, 0.9]
    kw = dict(lr=1e-3, factor=0.5, patience=2, threshold=1e-6, min_lr=2e-4)
    a, b = ReduceLROnPlateau(**kw), JPlateau(**kw)
    assert [a.step(x) for x in losses] == [b.step(x) for x in losses]
    assert a.state_dict() == b.state_dict()


@pytest.mark.parametrize("transform", [
    serving.fold_batch_norms,
    serving.cast_weights,
    lambda m: serving.pack_flat_encoders(serving.fold_batch_norms(m)),
    lambda m: serving.serving_variables(m, "bfloat16", flat=True),
], ids=["fold", "cast", "pack", "serving_variables"])
def test_trainer_refuses_serving_transformed_models(weights, transform):
    model = transform(port_model(weights))
    with pytest.raises(ValueError, match="serving transforms"):
        Trainer(model, 1e-3, device="cpu")
    Trainer(port_model(weights), 1e-3, device="cpu")  # the original trains


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(port_model(weights), 1e-3)
