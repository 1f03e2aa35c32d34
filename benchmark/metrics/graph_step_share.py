"""Share of train steps replayed from the train step's CUDA graph, in %:
the ``graph_steps`` of the system's ``train`` spans over their ``steps``.
None where a ``train`` span carries no ``graph_steps`` (a program without
the graph) or there are no steps."""


def read(run):
    steps = graph = 0
    for call in run.calls:
        for r in call.spans:
            if r.get("kind") != "train":
                continue
            attrs = r.get("attrs", {})
            if "graph_steps" not in attrs:
                return None
            steps += int(attrs["steps"])
            graph += int(attrs["graph_steps"])
    if steps == 0:
        return None
    return 100.0 * graph / steps
