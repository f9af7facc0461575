"""Closed loop: a fixed number of clients, each with one request in
flight, sending the next as soon as the last is answered.

Callers that each wait for their reply make this traffic: offline batch
jobs that keep a fixed number of requests outstanding.  A slower system
receives less load, so the metric is the work completed in the window.
Each answer sends that client's next request from the answer's own
callback (no coroutine per client).  Clients stop sending when the window
closes; what they have in flight then is still answered, and not
counted.  The seed orders the payloads.

Parameters: ``clients``.
"""

from __future__ import annotations

import asyncio
from typing import Dict

import numpy as np


def plan(params: Dict, seed: int, seconds: float, pool: int) -> Dict:
    return {"order": np.random.default_rng([seed, 0]).permutation(pool)}


async def drive(rec, params: Dict, plan: Dict, seconds: float) -> None:
    loop = asyncio.get_running_loop()
    stopped = loop.create_future()
    active = params["clients"]

    def send(_answered=None) -> None:
        nonlocal active
        if rec.now() < seconds:
            fut = rec.submit()
            if fut is None:             # refused at the door: try again
                loop.call_soon(send)
            else:
                fut.add_done_callback(send)
            return
        active -= 1
        if active == 0:
            stopped.set_result(None)

    for _ in range(params["clients"]):
        send()
    await stopped
