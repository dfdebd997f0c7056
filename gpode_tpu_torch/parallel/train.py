"""Sharded training steps: the shooting ELBO, its gradient and one Adam
update over a rank mesh, and posterior prediction with the draws split over
the ranks. Counterpart of `gpode_tpu/parallel/train.py`.

One step on every rank, in this order:

  1. the rank's part of the objective (`shooting.elbo_loss(mesh=...)`): its
     (S_l, N_l) block of segments integrated in one flow call, its local
     observation and continuity sums scaled to the global means, the
     entropy and both KLs on rank 0 only;
  2. the backward of that part, on the rank alone;
  3. ONE all-reduce (SUM) of one flat bucket: every gradient, then the
     five ELBO terms (detached, for the meters);
  4. ONE all-reduce (MAX) of the solver statistics [nfe, natt, -ncov]: the
     worst rank's budget use and coverage;
  5. Adam, on the summed gradient (the global-norm clip sees it whole).

So the gradient is the single-device objective's, with no factor of the
world size: an all-reduce inside a loss that every rank differentiates
would scale its backward by it, and summing whole-loss gradients would
count the replicated terms once per rank. No collective runs inside a
solve; both run after the backward, so a rank whose whole-span attempt was
rejected (its accept decision reads its own rows) takes the plain fallback
without holding the others. `COLLECTIVES_PER_STEP` is that design's count,
which `parallel/collective_audit.py` holds.

This module's step is the "gspmd" style: every rank draws the global
`StepNoise` of the single-device step from the shared train generator and
takes its block, so the sharded step computes the single-device step (equal
for fixed-step solvers and accepted whole-span attempts; an adaptive
fallback controls its step size on the rank's rows). It takes a segment
minibatch (one `segment_idx` for every rank). `parallel/shard_map_step.py`
is the other style.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward_batched
from gpode_tpu_torch.models.gpode import GPODEParams, PredictNoise
from gpode_tpu_torch.models.shooting import (ShootingELBOTerms, StepNoise,
                                             sample_step_noise)
from gpode_tpu_torch.parallel.mesh import Mesh
from gpode_tpu_torch.train.builders import ModelArgs, shooting_loss_fn

COLLECTIVES_PER_STEP = 2
_TERMS = ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl")


def check_step_mesh(mesh: Mesh, args: ModelArgs):
    """The sharded steps split sequences over `dp` and samples over `mc`;
    any other axis would repeat a block, and S must split over `mc`."""
    extra = set(mesh.axis_names) - {"dp", "mc"}
    if extra:
        raise ValueError(f"the sharded steps take the axes dp and mc; mesh "
                         f"{mesh.shape} has {sorted(extra)}")
    if args.num_samples % mesh.axis_size("mc"):
        raise ValueError(f"num_samples={args.num_samples} not divisible by "
                         f"mc={mesh.axis_size('mc')}")


@torch.no_grad()
def reduce_step(optimizer, terms: ShootingELBOTerms) -> ShootingELBOTerms:
    """Steps 3-4 above: sum every rank's gradients (written back into the
    parameters' `.grad`) and ELBO terms, take the worst rank's solver
    statistics; returns the global terms."""
    params = optimizer.params
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    values = torch.stack([getattr(terms, f).detach().reshape(())
                          for f in _TERMS]).to(grads[0].dtype)
    bucket = torch.cat([g.reshape(-1) for g in grads] + [values])
    dist.all_reduce(bucket)
    offset = 0
    for p in params:
        p.grad = bucket[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    stats = torch.tensor([terms.nfe, terms.natt, -terms.ncov],
                         dtype=torch.int64, device=bucket.device)
    dist.all_reduce(stats, dist.ReduceOp.MAX)
    nfe, natt, neg_ncov = stats.tolist()
    summed = dict(zip(_TERMS, bucket[offset:]))
    return ShootingELBOTerms(**summed, nfe=nfe, natt=natt, ncov=-neg_ncov)


def make_mesh_step(loss_fn: Callable, params, optimizer):
    """step(noise, *batch) -> global terms: the rank's partial loss
    (`loss_fn(params, noise, *batch)`), its backward, `reduce_step`, Adam
    (the frozen parameters' gradients are zeroed inside it)."""

    def step(noise, *batch):
        optimizer.zero_grad()
        loss, terms = loss_fn(params, noise, *batch)
        loss.backward()
        terms = reduce_step(optimizer, terms)
        optimizer.step()
        return terms

    return step


def block_noise(noise: StepNoise, mesh: Mesh) -> StepNoise:
    """The rank's block of a global `StepNoise`: its samples (over `mc`)
    and sequences (over `dp`) of the x0 and state normals; the draw's noise
    and the segment indices are every rank's."""
    s_lo, s_hi = mesh.sample_block(noise.x0.shape[0])
    n_lo, n_hi = mesh.sequence_block(noise.x0.shape[1])
    return dataclasses.replace(noise, x0=noise.x0[s_lo:s_hi, n_lo:n_hi],
                               states=noise.states[s_lo:s_hi, n_lo:n_hi])


def sharded_noise_fn(mesh: Mesh, args: ModelArgs):
    """noise(params, generator): the single-device step's noise (with the
    segment indices under `args.segment_minibatch`), of which the rank
    keeps its block (`block_noise`)."""
    def noise(params, generator):
        return block_noise(sample_step_noise(
            params, args.num_features, args.num_samples, generator,
            segment_minibatch=args.segment_minibatch), mesh)

    return noise


def make_sharded_shooting_step(mesh: Mesh, args: ModelArgs, params,
                               optimizer, kernels=None):
    """The "gspmd" style's step(noise, [itr,] ys, ts), for the noise of
    `sharded_noise_fn`, the rank's sequences `ys` and, when
    `args.constraint_anneal_iters` > 0, the iteration counter (annealing
    composes with the mesh)."""
    check_step_mesh(mesh, args)
    return make_mesh_step(shooting_loss_fn(args, kernels, mesh=mesh), params,
                          optimizer)


def make_sharded_predict(mesh: Mesh, cfg: SolverConfig):
    """Posterior prediction with the draws split over the first mesh axis:
    predict(params, noise, ts, x0) -> (S, N, T, D) on every rank, for a
    `GPODEParams` (or a shooting model's view), the `PredictNoise` of all S
    draws (S divisible by the axis size) and the start states x0 (N, D).

    Each rank solves its block of draws in one batched solve (its step-size
    control, for adaptive solvers, over its own draws), then one all-gather
    assembles the draws in order; ranks that share a block along the other
    axes compute it alike."""
    axis = mesh.axis_names[0]

    @torch.no_grad()
    def predict(params: GPODEParams, noise: PredictNoise, ts: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
        lo, hi = mesh.block(axis, noise.inducing.shape[0])
        chol = gp.precompute_chol(params.gp)
        draws = gp.draw_posterior(params.gp, noise.rff_weights[lo:hi],
                                  noise.rff_freq[lo:hi], noise.rff_phase[lo:hi],
                                  noise.inducing[lo:hi], chol)
        starts = x0.expand(hi - lo, *x0.shape)
        xs, _ = flow_forward_batched(params.gp, draws, starts, ts, cfg)
        blocks = [torch.empty_like(xs) for _ in range(mesh.size)]
        dist.all_gather(blocks, xs.contiguous())
        # one block per index along the first axis: the ranks whose other
        # coordinates are all 0
        firsts = [r for r in range(mesh.size)
                  if all(c == 0 for a, c in mesh.coords_of(r).items()
                         if a != axis)]
        return torch.cat([blocks[r] for r in firsts])

    return predict
