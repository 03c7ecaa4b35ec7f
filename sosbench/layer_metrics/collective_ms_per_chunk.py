"""collective_ms_per_chunk: device ms of the NCCL all-gather kernels (the
mesh's ``all_gather_into_tensor`` of each chunk's result, which includes
the wait for the slowest rank) per chunk of the traced window, the mean
over ranks.  The benchmark's own collectives (the stop flag's broadcast,
barriers) are other kernels and stay out."""
UNIT = "ms"


def read(run):
    if not run.records:
        return None
    per_rank = [sum(k["s"] for name, k in r["kernels"].items()
                    if "nccl" in name.lower() and "allgather" in name.lower())
                for r in run.ranks]
    if not any(per_rank):
        return None
    return 1e3 * sum(per_rank) / len(per_rank) / len(run.records)
