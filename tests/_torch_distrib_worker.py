"""One rank of the port's sharded attention under ``torch.distributed``
(gloo, CPU), started by tests/test_torch_distrib.py:

    python _torch_distrib_worker.py RANK WORLD INIT_FILE DATA.npz OUT.npz

Loads the shared inputs, keeps this rank's shard of every cache (a
contiguous slice of the sequence axis, or of the pool's block axis),
runs each sharded function and saves the merged outputs.  Imports only
torch, numpy and the port.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist


def run_cases(t, rank: int, world: int):
    from repro_torch.distrib import decode_attn as da
    s_loc = t["k"].shape[1] // world
    nb_loc = t["pk"].shape[0] // world
    kc = t["k"][:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    vc = t["v"][:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    pk = t["pk"][rank * nb_loc:(rank + 1) * nb_loc]
    pv = t["pv"][rank * nb_loc:(rank + 1) * nb_loc]
    vlen = t["offs"] + t["nnew"]
    return {
        "decode": da.sharded_decode_attention(t["q"], kc, vc, t["clen"]),
        "mixed": da.sharded_mixed_attention(t["qm"], kc, vc, vlen,
                                            t["offs"]),
        "paged_mixed": da.sharded_paged_mixed_attention(
            t["qm"], pk, pv, t["tbl"], vlen, t["offs"]),
        "paged_decode": da.sharded_paged_mixed_attention(
            t["q"], pk, pv, t["tbl"], t["clen"]),
        "paged_long": da.sharded_paged_mixed_attention(
            t["q_long"], pk, pv, t["tbl_long"], t["off_long"] + 2,
            t["off_long"], impl="torch"),
        "paged_packed": da.sharded_packed_mixed_attention(
            t["q_flat"], pk, pv, t["tbl"], t["seg"], t["vlen_flat"],
            t["qoff_flat"]),
    }


def main(rank: int, world: int, init_file: str, data: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    t = {k: torch.from_numpy(v) for k, v in np.load(data).items()}
    res = run_cases(t, rank, world)
    np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
