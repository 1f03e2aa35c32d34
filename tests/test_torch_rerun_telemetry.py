"""The JAX package's ``tests/test_telemetry.py``, run against the port's copies.

One repair, in this copy only: the end-to-end search starts its two worker
threads after ``RunTelemetry`` is entered.  The broker sets
``broker_workers_connected`` when a worker joins or leaves while telemetry
is on, so in the reference's order (workers first) a worker whose hello
lands before the run installs its sink leaves the gauge unset, and
``test_two_worker_search_produces_linked_artifact`` fails now and then.
``tests/test_torch_telemetry.py::test_connected_gauge_is_set_by_joins_under_telemetry``
shows both orders.  The telemetry-off search starts its workers the same
way, so the bit-identity case compares like with like.
"""

from _torch_rerun import load

load(globals(), "test_telemetry.py", subs=[(
    '''        stops = []
        for i in range(2):
            stop = threading.Event()
            threading.Thread(
                target=lambda s=stop, wid=f"w{i}": GentunClient(
                    OneMax, *DATA, host="127.0.0.1", port=port,
                    heartbeat_interval=0.2, reconnect_delay=0.1,
                    worker_id=wid,
                ).work(stop_event=s),
                daemon=True,
            ).start()
            stops.append(stop)
        try:
            ga = GeneticAlgorithm(pop, seed=6)
            if telemetry_path is not None:
                with RunTelemetry(telemetry_path, label="e2e") as run:
                    best = ga.run(3)
                summary = run.summary()
            else:
                best = ga.run(3)
                summary = None''',
    '''        stops = []

        def start_workers():
            for i in range(2):
                stop = threading.Event()
                threading.Thread(
                    target=lambda s=stop, wid=f"w{i}": GentunClient(
                        OneMax, *DATA, host="127.0.0.1", port=port,
                        heartbeat_interval=0.2, reconnect_delay=0.1,
                        worker_id=wid,
                    ).work(stop_event=s),
                    daemon=True,
                ).start()
                stops.append(stop)
        try:
            ga = GeneticAlgorithm(pop, seed=6)
            if telemetry_path is not None:
                with RunTelemetry(telemetry_path, label="e2e") as run:
                    start_workers()
                    best = ga.run(3)
                summary = run.summary()
            else:
                start_workers()
                best = ga.run(3)
                summary = None''',
)])
