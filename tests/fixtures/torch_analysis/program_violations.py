"""Seeded program-audit violations, in torch: one program per JX check ID
(the port's counterpart of tests/fixtures/analysis/jaxpr_violations.py).

Each function below, registered as a ProgramSpec by
tests/test_torch_program_audit.py, trips exactly one check and nothing
else; the test asserts the exact finding list, so that a dead check (or
a check firing twice) is loud. They run on small CPU tensors under the
recorder.
"""
import torch

from repro_torch.kernels import ops


def hostcall(x):
    """JX101: a scalar read to the host inside a hot program."""
    if float(x.sum()) > 1e9:
        return x
    return x + 1


def tp_hostcall(mesh, q, planes):
    """JX101 again, from inside a tensor-parallel shard's run: the
    recorder sees every shard of `ops._per_shard`, not only the caller."""
    def run(r, h0, h1, q_r):
        return q_r * len(planes[r].tolist())
    return ops._per_shard(mesh, q, 2, planes, run)


def packed_cast(codes):
    """JX102: packed int8 codes decoded to float outside any kernel."""
    return codes.to(torch.float32) * 0.5


def laundered_cast(codes):
    """JX102 through an int32 widen: the taint rides the integer op."""
    return (codes.to(torch.int32) + 1).to(torch.float32)


def kernel_decode(store, meta, scale):
    """Clean: the float plane comes out of the meta-decode kernel."""
    return ops.sparq_dequantize(store, meta, scale) * 2.0


def tile_misdivide(store, meta):
    """JX103: a row of 15 lanes is not a whole number of vSPARQ pairs,
    which K6 does not mask (its plain version takes it; the card's
    wrapper would raise)."""
    return ops.sparq_dequantize(store, meta)


def page_tile_mismatch(q, kd, km, ks, vd, vm, vs, kpos, cur):
    """JX104: contiguous planes read in tiles of 8 keys in a program that
    declares pages of 16 (the replay's `attn_bk` left off the page)."""
    return ops.sparq_decode_attention(q, kd, km, ks, vd, vm, vs, kpos, cur,
                                      bk=8)


def smem_hog(q, kd, km, ks, vd, vm, vs, bt, cur):
    """JX105 under a small test budget: one block of K2's split-key body
    holds more than the budget's bytes."""
    return ops.sparq_paged_decode_attention(q, kd, km, ks, vd, vm, vs, bt,
                                            cur)


def shape_polymorphic(x):
    """JX106 when registered with a two-length shape set: one signature
    per length, which one captured graph cannot serve."""
    return x * 2
