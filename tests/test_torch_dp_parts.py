"""The pieces of the port's data parallelism: the group-aware layers on two
gloo ranks on the CPU against the same layers on the whole batch in one
process, the batch split, the state's replication, and the refusals
(counterparts of the JAX package's tests/test_parallel.py checks of
check_batch_divisible and process_batch_rows).

On the ranks each piece sees its rank's rows of a global batch of 4.  The
global loss of a data-parallel step is the mean of the ranks' losses, so
a rank's gradient of its own loss, through the all-reduced means, is W
times its rows' share of the global gradient; a sum over the batch (the
BatchNorm checks) gives its rows' share itself.  Tolerances: 1e-6 (f32
sums split in two).
"""

import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_torch.config import Config
from deepinpainting_torch.data.iterator import BatchIterator
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.losses import ra_gan_loss
from deepinpainting_torch.ops.convs import BatchNorm
from deepinpainting_torch.parallel import mesh

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parts")
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm(6)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(6, generator=g))
    inputs = {"fake": torch.randn(4, 1, 6, 6, generator=g),
              "real": torch.randn(4, 1, 6, 6, generator=g) + 0.5,
              "x": 2.0 + torch.randn(4, 6, 5, 5, generator=g),
              "w": torch.randn(4, 6, 5, 5, generator=g),
              "bn": dict(bn.state_dict())}
    torch.save(inputs, tmp / "inputs.pt")
    W.run_ranks(W.dp_parts, 2, tmp)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return inputs, ranks


def _whole_batch_norm(inputs):
    """The layer on the whole batch in one process: (y, x.grad, state)."""
    bn = BatchNorm(inputs["x"].shape[1])
    bn.load_state_dict(inputs["bn"])
    x = inputs["x"].clone().requires_grad_(True)
    y = bn(x)
    (y * inputs["w"]).sum().backward()
    return y.detach(), x.grad, bn.state_dict()


def test_ra_gan_loss_takes_the_global_batch_means(parts):
    inputs, ranks = parts
    fake = inputs["fake"].clone().requires_grad_(True)
    real = inputs["real"].clone().requires_grad_(True)
    loss = ra_gan_loss(fake, real, True)
    loss.backward()
    got = np.mean([r["gan"][0] for r in ranks])
    np.testing.assert_allclose(got, float(loss.detach()), **TOL)
    for i, want in ((1, fake.grad), (2, real.grad)):
        got = torch.cat([r["gan"][i] for r in ranks]) / len(ranks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # a rank's local means alone give another loss: the reduction matters
    local = ra_gan_loss(inputs["fake"][:2], inputs["real"][:2], True)
    assert abs(float(local) - ranks[0]["gan"][0]) > 1e-3


@pytest.mark.parametrize("part", ["bn", "remat"])
def test_batch_norm_normalises_by_the_global_moments(parts, part):
    """Output, input gradient and running statistics (the unbiased
    variance of the global count) are the whole batch's, in train mode
    and in a checkpointed level whose recompute runs in another thread,
    which sees the group and moves the statistics once."""
    inputs, ranks = parts
    y, x_grad, stats = _whole_batch_norm(inputs)
    np.testing.assert_allclose(
        torch.cat([r[part][0] for r in ranks]).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(
        torch.cat([r[part][1] for r in ranks]).numpy(), x_grad.numpy(),
        **TOL)
    for r in ranks:
        for k, v in stats.items():
            np.testing.assert_allclose(r[part][2][k].numpy(), v.numpy(),
                                       **TOL, err_msg=k)
        assert int(r[part][2]["num_batches_tracked"]) == 1
    if part == "remat":     # the forward, then the recompute
        assert [r["remat"][3] for r in ranks] == [[True, True]] * 2


def test_frozen_running_stats_keep_their_meaning(parts):
    """Under frozen_running_stats the layer still normalises by the
    global moments and leaves the statistics where they were."""
    inputs, ranks = parts
    y, _, stats = _whole_batch_norm(inputs)
    np.testing.assert_allclose(
        torch.cat([r["frozen"][0] for r in ranks]).numpy(), y.numpy(),
        **TOL)
    for r in ranks:
        for k, v in r["bn"][2].items():
            assert torch.equal(r["frozen"][1][k], v), k


def test_replicate_state_makes_every_rank_rank_0s(parts):
    _, (r0, r1) = parts
    fresh = TI.create_state(Config(fine_size=64, ngf=8, ndf=8,
                                   vgg_width_scale=1 / 8, norm="batch"),
                            torch.Generator().manual_seed(1), "cpu")
    assert not torch.equal(next(iter(r1["replicated"]["G"].values())),
                           next(iter(fresh.G.state_dict().values())))
    n = 0
    for net in ("G", "P", "D", "F", "vgg"):
        for k, v in r0["replicated"][net].items():
            assert torch.equal(r1["replicated"][net][k], v), f"{net}.{k}"
            n += 1
    moments = [(s0, s1) for s0, s1 in zip(
        r0["replicated"]["opt_G"]["state"].values(),
        r1["replicated"]["opt_G"]["state"].values())]
    assert moments
    for s0, s1 in moments:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s0[k], s1[k])
    assert n > 50


def test_process_batch_rows():
    """One contiguous slice a rank (the JAX package's rows); with
    grad_accum k the rank's share of each of the k global microbatches."""
    assert [mesh.process_batch_rows(8, r, 2) for r in (0, 1)] == [
        (0, 4), (4, 8)]
    assert [mesh.process_batch_rows(8, r, 4) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert mesh.process_batch_rows(8, 0, 1) == (0, 8)
    assert [mesh.process_batch_rows(8, r, 2, grad_accum=2)
            for r in (0, 1)] == [[(0, 2), (4, 6)], [(2, 4), (6, 8)]]
    assert mesh.row_index(mesh.process_batch_rows(
        12, 1, 2, grad_accum=3)) == [2, 3, 6, 7, 10, 11]
    # the ranks' rows cover the global batch once
    for k in (1, 2, 4):
        rows = sorted(i for r in range(2) for i in mesh.row_index(
            mesh.process_batch_rows(8, r, 2, grad_accum=k)))
        assert rows == list(range(8))


def test_refusals_name_the_batch_and_the_ranks():
    with pytest.raises(ValueError, match=r"batch_size=6 is not divisible "
                       r"by 4 rank\(s\)"):
        mesh.check_batch_divisible(6, 4)
    with pytest.raises(ValueError, match=r"batch_size=4 is not divisible "
                       r"by grad_accum=4 microbatches over 2 rank\(s\)"):
        mesh.process_batch_rows(4, 0, 2, grad_accum=4)
    with pytest.raises(ValueError, match="rank 2 is not in a group of 2"):
        mesh.process_batch_rows(4, 2, 2)
    mesh.check_batch_divisible(8, 4)
    mesh.check_batch_divisible(8, 2, grad_accum=4)
    with pytest.raises(ValueError, match="must be given together"):
        mesh.init_distributed("cpu", coordinator="localhost:1234")
    assert mesh.default_group() is None


def test_shard_batch_and_row_sliced_loader_agree():
    """shard_batch of a host batch, and BatchIterator(rows=...) over the
    same seeded epoch, give each rank the same rows, in order."""

    class Items:
        def __len__(self):
            return 16

        def fetch(self, i, rng):
            return {"image": np.full((2, 2, 3), i, np.uint8),
                    "mask": rng.integers(0, 2, (2, 2)).astype(np.uint8),
                    "ref": np.zeros((2, 2, 3), np.uint8)}

    whole = list(BatchIterator(Items(), 8, seed=3))
    for k in (1, 2):
        for r in (0, 1):
            rows = mesh.process_batch_rows(8, r, 2, grad_accum=k)
            mine = list(BatchIterator(Items(), 8, seed=3, rows=rows))
            assert len(mine) == len(whole) == 2
            for got, batch in zip(mine, whole):
                want = mesh.shard_batch(batch, r, 2, grad_accum=k)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="non-empty slices"):
        BatchIterator(Items(), 8, rows=[(0, 2), (5, 5)])
