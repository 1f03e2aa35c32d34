"""The CUDA allocator's reserved memory at a call's end, the largest over the
window's calls, GiB: the ``reserved_bytes`` of the system's ``cv_call``
spans, which count the train step's graph pool and the blocks the
allocator keeps cached, where ``peak_mem_gib`` counts live tensors only.
None where no ``cv_call`` span carries it (a program without the counter)."""


def read(run):
    got = [r["attrs"]["reserved_bytes"] for call in run.calls for r in call.spans
           if r.get("kind") == "cv_call" and "reserved_bytes" in r.get("attrs", {})]
    if not got:
        return None
    return max(got) / 2.0 ** 30
