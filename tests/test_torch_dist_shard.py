"""The JAX package's ``tests/test_shard.py``, run against the port's copy.

One seam: the multi-home credit case reads each shard's credit books as
soon as both searches have their results.  A worker returns a batch's
credit in a ``ready`` frame that it sends after the batch's results, so
under load the case read a book while that return was still on the wire
(``credit`` 2 against a window of 3).  The port's copy waits, bounded, for
the books to balance before it asserts them; the assertions are the
reference's.  ``test_credit_books_balance_in_twenty_runs`` runs the case 20
times.
"""

from _torch_rerun import load


def _books_balanced(*brokers) -> bool:
    for broker in brokers:
        status = broker._ops_status()
        if status["open_jobs"] or status["jobs_in_flight"]:
            return False
        if any(w["credit"] != w["capacity"] + w["prefetch_depth"] for w in status["workers"]):
            return False
    return True


load(globals(), "test_shard.py", subs=[(
    "            for broker in (b1, b2):\n"
    "                status = broker._ops_status()\n",
    "            assert _wait(lambda: _books_balanced(b1, b2), timeout=10.0)\n"
    "            for broker in (b1, b2):\n"
    "                status = broker._ops_status()\n",
)])


def test_credit_books_balance_in_twenty_runs():
    case = TestMultihomeCreditConservation()  # noqa: F821 - defined by load()
    for _ in range(20):
        case.test_concurrent_sessions_two_shards_with_drain()
