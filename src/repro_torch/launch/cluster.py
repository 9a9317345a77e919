"""Multi-host launch boundary (documented interface): the port of the
argument-checking stub `repro.launch.cluster`.

On a real fleet each host runs:

    python -m repro_torch.launch.cluster --coordinator <addr> --pod-id <i>

which would call `torch.distributed.init_process_group("nccl",
init_method="tcp://<addr>", world_size=..., rank=...)`, build
`launch.mesh.make_production_mesh(multi_pod=True)` over the default
group, run one BW-Raft voter node (the per-host control agent speaking
the record schema in `repro_torch.coord.log_records`), and enter
`launch.train`'s loop with `shard=pod_id`.  This module only validates
arguments and prints the would-be topology: the code paths it delegates
to (mesh building, steps, coordinator records, checkpoint commit) are
what the in-process tests exercise.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:1234")
    ap.add_argument("--num-pods", type=int, default=2)
    ap.add_argument("--pod-id", type=int, default=0)
    ap.add_argument("--chips-per-pod", type=int, default=256)
    args = ap.parse_args(argv)
    print(f"[cluster] pod {args.pod_id}/{args.num_pods} @ "
          f"{args.coordinator}; {args.chips_per_pod} chips/pod")
    print("[cluster] would call torch.distributed.init_process_group("
          "'nccl', ...), build make_production_mesh(multi_pod=True), start "
          "the BW-Raft voter agent, then exec repro_torch.launch.train "
          "with shard=pod_id")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
