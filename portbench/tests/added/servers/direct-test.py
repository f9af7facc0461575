"""A server added as a file alone (test only): a kind's frozen plan
compiled at bucket 1 and called on each request as it is submitted, on
the event loop, without the gateway.  Each answer emits the kind's units
per request."""

import asyncio

from portbench import harness


class Recorder(harness.Recorder):
    def __init__(self, server, order, keep):
        super().__init__(server.system.pool, order, keep)
        self.server = server

    def hand_over(self, i):
        x = self.pool[self.payload_index(i):self.payload_index(i) + 1]
        fut = asyncio.get_running_loop().create_future()
        fut.set_result(self.server.compiled(x)[0].cpu().numpy())
        return fut

    def _finished(self, i, fut):
        super()._finished(i, fut)
        if self.status[i] == "done":
            self.emit(self.server.system.units_per_request, self.done[i])


class Server:
    def __init__(self, system, cell, seed, device, config_dir):
        from repro_torch.runtime import compile_plan, load_plan
        self.system, self.cell = system, cell
        self.compiled = compile_plan(
            load_plan(config_dir / system.config["plan"]),
            params=system.params(), device=device, max_batch=1)
        self.compiled(system.pool[:1])

    def profiler_warmup(self):
        pass

    async def warm(self):
        pass

    def recorder(self, order, keep):
        return Recorder(self, order, keep)

    async def close(self, rec):
        pass

    def data(self, rec, **common):
        return harness.RunData(**common, ops_per_unit=(
            self.system.ops_per_request / self.system.units_per_request))

    def release(self):
        self.compiled = None

    def check(self, rec, data, rng, *, control=False):
        payload = [rec.payload_index(i) for i in range(len(rec.sent))]
        return self.system.check(rec.answers, payload, [], rng,
                                 self.cell["check"]["compare"],
                                 control=control)
