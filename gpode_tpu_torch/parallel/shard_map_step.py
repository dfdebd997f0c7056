"""The per-rank-noise ("shard_map") shooting step. Counterpart of
`gpode_tpu/parallel/shard_map_step.py`.

The JAX module runs the ELBO in a `shard_map` region: every device samples
its own (S_l, N_l) block of shooting states from a key folded with its mesh
coordinates, integrates it, and `psum`s its likelihood and continuity sums;
the entropy and both KLs are computed on the replicated parameters. The
port's steps are explicit on every rank anyway (`parallel/train.py`), so
this style differs from the "gspmd" one only in its noise: each rank's
block of state normals is a draw of its own, of the shapes JAX draws
(x0 (S_l, N_l, D), states (S_l, N_l, T-1, D)), while the posterior draw's
noise is every rank's. The local sums, the replicated terms and the
worst-rank statistics are `shooting.elbo_loss(mesh=...)` and
`parallel.train.reduce_step`, shared with the other style; the sequence
block's sampling is `states.sample_shooting_states(seqs=...)`.

How a rank's normals are drawn: from the shared train generator, which
draws the posterior draw's noise and then every block's normals in rank
order, each rank keeping its own. The generator advances alike on every
rank, so the checkpointed generator state reproduces every rank's stream
on `--resume`, and with one rank the noise is the single-device step's.
The blocks are independent draws: a statistically equivalent estimator,
not the single-device step's numbers (JAX's `fold_in` keys likewise). The
step integrates fixed per-rank blocks, so it takes no segment minibatch.
"""

from __future__ import annotations

import torch

from gpode_tpu_torch.models.shooting import StepNoise, sample_draw_noise
from gpode_tpu_torch.parallel.mesh import Mesh
from gpode_tpu_torch.parallel.train import check_step_mesh, make_mesh_step
from gpode_tpu_torch.train.builders import ModelArgs, shooting_loss_fn


def sample_block_noise(params, mesh: Mesh, num_features: int,
                       num_samples: int,
                       generator: torch.Generator) -> StepNoise:
    """This rank's `StepNoise`: the draw's noise, then every rank's block
    of x0 and state normals in rank order, of which it keeps its own."""
    n, t1, d = params.states.mean.shape
    kw = dict(generator=generator, device=params.gp.z.device)
    draw = sample_draw_noise(params, num_features, generator)
    s_lo, s_hi = mesh.sample_block(num_samples)
    n_lo, n_hi = mesh.sequence_block(n)
    s_l, n_l = s_hi - s_lo, n_hi - n_lo
    for rank in range(mesh.size):
        x0 = torch.randn(s_l, n_l, d, **kw)
        states = torch.randn(s_l, n_l, t1, d, **kw)
        if rank == mesh.rank:
            mine = StepNoise(**draw, x0=x0, states=states)
    return mine


def shard_map_noise_fn(mesh: Mesh, args: ModelArgs):
    """noise(params, generator) = `sample_block_noise`."""
    def noise(params, generator):
        return sample_block_noise(params, mesh, args.num_features,
                                  args.num_samples, generator)

    return noise


def make_shard_map_shooting_step(mesh: Mesh, args: ModelArgs, params,
                                 optimizer, kernels=None):
    """The per-rank-noise style's step(noise, [itr,] ys, ts), for the noise
    of `shard_map_noise_fn`, the rank's sequences `ys` and, when
    `args.constraint_anneal_iters` > 0, the iteration counter (annealing
    composes with the mesh). Frozen parameters are the optimizer's."""
    check_step_mesh(mesh, args)
    if args.segment_minibatch > 0:
        raise ValueError("the per-rank-noise step integrates fixed per-rank "
                         "segment blocks; a segment minibatch needs the "
                         "gspmd step")
    return make_mesh_step(shooting_loss_fn(args, kernels, mesh=mesh), params,
                          optimizer)
