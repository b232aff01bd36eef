"""Multi-device left-looking tile Cholesky: the baseline (paper §IV-D,
Fig. 5/9).

Port of ``repro/core/distributed.py``, re-derived in PyTorch over the
port's logical devices (:func:`repro_torch.core.api.logical_devices`:
the first ``ndev`` cards, a list such as ``["cuda:0"] * 4`` that shares
one card, or ``"cpu"``):

* tile-row ``i`` is owned by device ``i % P`` (block-cyclic, Fig. 5a);
  each device holds its rows as one dense ``[nt / P * tb, n]`` slab;
* the left-looking order makes the *panel row broadcast* the only
  communication: at column step ``k`` the owner finalizes the diagonal
  tile, then sends row ``k``'s first ``k + 1`` tiles (which are final) to
  every other device, and every device updates its own rows of column
  ``k`` locally.

The reference broadcasts the whole row masked with zeros (a ``psum``) and
contracts over the full width; here the owner sends only the nonzero
``k + 1`` tiles, so the bytes sent are exactly :func:`panel_broadcast_bytes`
at the dtype's word size, and the SYRK and GEMM sweeps contract over the
``k`` finished tiles only (dropping products with exact zeros).  Only the
rows whose global index exceeds ``k`` are updated: the reference computes
the others and discards them.

Each logical device issues on a CUDA stream of its own; a sent row is a
device-to-device copy issued on the receiver's stream after it waits on an
event recorded on the owner's, as ``MultiDeviceTorchExecutor`` orders its
wires.  The tile math is PyTorch's (``matmul``, ``linalg.cholesky_ex``,
``linalg.solve_triangular``), as the reference's is ``einsum`` and
``jnp.linalg``: this path reaches no hand-written kernel.

This is the check on the multi-device executors that shares no code with
them: keep it simple, its value is an independently derived answer, not
speed.  :func:`modeled_scaling` ties the Fig. 9 scaling argument to the
exact op streams the executor replays.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def _cyclic_permute(nt: int, p: int) -> np.ndarray:
    """Global row order so that contiguous shards = block-cyclic ownership.

    Device d gets global rows [d, d+P, d+2P, ...] as its contiguous slab.
    """
    return np.concatenate([np.arange(d, nt, p) for d in range(p)])


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """Issue on ``device``'s card and ``stream`` (nothing on the CPU)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _send(panel: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The owner's finished row ``panel`` as the receiver ``device``
    holds it: a copy issued on the receiver's current stream.  Between two
    cards PyTorch runs the copy on the sending card's current stream, which
    the caller sets to the owner's, behind a barrier with the receiver's."""
    out = torch.empty(panel.shape, dtype=panel.dtype, device=device)
    return out.copy_(panel, non_blocking=True)


def distributed_cholesky_with_stats(a, tb: int, ndev: int, device=None,
                                    dtype=torch.float64) -> tuple:
    """:func:`distributed_cholesky` and its counters: ``(L, stats)``, with
    ``stats`` the column steps run, the rows sent (``bcast_copies``,
    ``bcast_bytes``: one per receiver, at ``dtype``'s word size) and
    ``factor_s``, the host seconds from the slabs' set-up to every
    stream's end of the column steps (the rest of the call is set-up and
    the copy of L to the host)."""
    import time

    from .api import logical_devices

    n = a.shape[0]
    if n % tb:
        raise ValueError(f"n={n} must be a multiple of tb={tb}")
    nt = n // tb
    p = ndev
    if nt % p != 0:
        raise ValueError(f"Nt={nt} must be divisible by device count {p}")
    nt_loc = nt // p
    devices = logical_devices(device, p)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, dtype=np.float64))
    rows = a.reshape(nt, tb, n)
    glob = _cyclic_permute(nt, p).reshape(p, nt_loc)  # [d, r] -> tile row

    slabs = []
    for d, dev in enumerate(devices):
        if streams[d] is not None:    # after the work that made ``a``
            streams[d].wait_stream(torch.cuda.current_stream(dev))
        with _on(dev, streams[d]):
            slab = torch.empty((nt_loc * tb, n), dtype=dtype, device=dev)
            slab.view(nt_loc, tb, n).copy_(rows[d::p])   # rows glob[d]
            slabs.append(slab)

    stats = {"steps": 0, "bcast_copies": 0, "bcast_bytes": 0}
    t0 = time.perf_counter()
    for k in range(nt):
        owner, c0, c1 = k % p, k * tb, (k + 1) * tb
        rk = k // p
        row = slabs[owner][rk * tb:(rk + 1) * tb]
        # 1) the owner's SYRK sweep and the diagonal tile's factor
        with _on(devices[owner], streams[owner]):
            done = row[:, :c0]
            akk = row[:, c0:c1] - done @ done.mT
            row[:, c0:c1] = torch.linalg.cholesky_ex(0.5 * (akk + akk.mT)).L
            ready = None
            if streams[owner] is not None:
                ready = torch.cuda.Event()
                ready.record(streams[owner])
        panel = row[:, :c1]                     # row k's first k + 1 tiles
        for d, dev in enumerate(devices):
            with _on(devices[owner], streams[owner]), _on(dev, streams[d]):
                # 2) the row, sent to every other device
                if d == owner:
                    rowk = panel
                else:
                    if ready is not None:
                        streams[d].wait_event(ready)
                    rowk = _send(panel, dev)
                    stats["bcast_copies"] += 1
                    stats["bcast_bytes"] += (panel.numel()
                                             * panel.element_size())
                # 3) the GEMM sweep and X L[k,k]^T = C on this device's rows
                # below row k (local rows r0.., whose global index is > k)
                r0 = int(np.searchsorted(glob[d], k, side="right"))
                if r0 == nt_loc:
                    continue
                below = slabs[d][r0 * tb:]
                c = below[:, c0:c1] - below[:, :c0] @ rowk[:, :c0].mT
                below[:, c0:c1] = torch.linalg.solve_triangular(
                    rowk[:, c0:c1].mT, c, upper=True, left=False)
        stats["steps"] += 1
    for stream in streams:
        if stream is not None:
            stream.synchronize()
    stats["factor_s"] = time.perf_counter() - t0

    # tril (the strictly upper tiles still hold the input, as the
    # reference's store does before its np.tril), then each tile row into
    # its rows of L on the host
    out = torch.empty((n, n), dtype=torch.float64)
    for d, dev in enumerate(devices):
        with _on(dev, streams[d]):
            for r, g in enumerate(glob[d]):
                blk = slabs[d][r * tb:(r + 1) * tb]
                blk[:, (g + 1) * tb:] = 0
                blk[:, g * tb:(g + 1) * tb].tril_()
        if streams[d] is not None:
            streams[d].synchronize()    # the copies run on another stream
        for r, g in enumerate(glob[d]):
            out[g * tb:(g + 1) * tb].copy_(slabs[d][r * tb:(r + 1) * tb])
    return out.numpy(), stats


def distributed_cholesky(a, tb: int, ndev: int, device=None,
                         dtype=torch.float64) -> np.ndarray:
    """Factor SPD ``a`` (an ndarray, or a tensor on any device) across
    ``ndev`` logical devices (``device``: see
    :func:`repro_torch.core.api.logical_devices`; None is the first
    ``ndev`` cards).  Returns L as a host f64 ndarray, upper part zero.
    Raises ``ValueError`` when ``nt = n / tb`` is not a multiple of
    ``ndev``.  A matrix that is not positive definite gives NaNs, as the
    reference's does; nothing falls back to the CPU."""
    return distributed_cholesky_with_stats(a, tb, ndev, device, dtype)[0]


def panel_broadcast_bytes(nt: int, tb: int, p: int, word: int = 8) -> int:
    """Analytic per-factorization collective volume: one row-k broadcast per
    step, each (k+1) tiles to (P-1) receivers (for the roofline model).

    The static multi-device schedule reproduces this number exactly:
    ``build_multidevice_schedule(nt, tb, p).bcast_bytes()`` (uniform-f64
    plans) sums the same tiles op by op."""
    total_tiles = sum(k + 1 for k in range(nt))
    return total_tiles * tb * tb * word * (p - 1)


def grid_broadcast_bytes(nt: int, tb: int, grid: tuple,
                         word: int = 8) -> int:
    """Analytic collective volume of the ``p x q`` 2D block-cyclic
    schedule (uniform word-size tiles): at step ``k`` the panel row
    ``(k, 0..k)`` goes to the ``p - 1`` other devices of grid column
    ``k % q``, and each finalized column tile ``(m, k)``, ``m > k``,
    goes to its ``q - 1`` grid-row peers.

    ``grid=(P, 1)`` reduces to :func:`panel_broadcast_bytes`; for a true
    2D factorization of ``P >= 2`` devices the total is strictly smaller
    (roughly ``(p + q - 2) / (P - 1)`` of the 1D volume, the classic
    O(sqrt(P)) communication scaling).  The static schedule reproduces
    this number exactly:
    ``build_multidevice_schedule(nt, tb, p*q, grid=grid).bcast_bytes()``.
    """
    p, q = grid
    panel_tiles = sum(k + 1 for k in range(nt))          # column-scoped
    column_tiles = sum(nt - 1 - k for k in range(nt))    # row-scoped
    return tb * tb * word * ((p - 1) * panel_tiles
                             + (q - 1) * column_tiles)


def modeled_scaling(nt: int, tb: int, ndevs=(1, 2, 4), policy: str = "v3",
                    hw_name: str = "gh200",
                    link_bw: float | None = None,
                    grid_of=None) -> list[dict]:
    """Fig. 9 scaling rows from the *same static schedules the executors
    replay* — an exact event simulation, not a side-channel estimate.

    For each device count, builds the block-cyclic multi-device schedule
    (1D tile-row ownership by default; ``grid_of`` maps a device count
    to an explicit ``(p, q)`` grid, e.g. ``{4: (2, 2)}``), runs
    :func:`~repro_torch.core.analytics.simulate_multi` on the named
    hardware preset (``link_bw`` overrides the interconnect), and reports
    makespan, speedup/efficiency vs the 1-device schedule, and the
    broadcast volume.  A model reading, not a measurement."""
    from .analytics import HW, simulate_multi
    from .schedule import build_multidevice_schedule

    hw = HW[hw_name]
    grid_of = grid_of or {}
    m1 = build_multidevice_schedule(nt, tb, 1, policy)
    r1 = simulate_multi(m1, hw, link_bw=link_bw)
    t1 = r1.makespan
    rows = []
    for p in ndevs:
        if p == 1:
            msched, r = m1, r1
        else:
            msched = build_multidevice_schedule(nt, tb, p, policy,
                                                grid=grid_of.get(p))
            r = simulate_multi(msched, hw, link_bw=link_bw)
        rows.append({
            "ndev": p,
            "grid": list(msched.grid),
            "hw": hw_name,
            "policy": policy,
            "makespan": r.makespan,
            "tflops": r.tflops,
            "speedup": t1 / r.makespan,
            "efficiency": t1 / (p * r.makespan),
            "compute_efficiency": r.compute_efficiency,
            "bcast_bytes": msched.bcast_bytes(),
            "link_busy": r.link_busy,
        })
    return rows
