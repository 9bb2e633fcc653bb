"""ServerThread: run a Server on its own event loop in a daemon thread.

The embedding primitive for synchronous callers (CLI tools, tests,
benchmarks): the control plane runs like a separate process — its own
loop owns the store — and callers talk to it over HTTP with RestClient,
exactly as the reference's standalone binaries talk to `kcp start`
(reference: cmd/cluster-controller/main.go, cmd/syncer/main.go).
"""

from __future__ import annotations

import asyncio
import threading

from .server import Config, Server


class ServerThread:
    def __init__(self, config: Config | None = None, **server_kwargs):
        self._config = config or Config(durable=False)
        self._server_kwargs = server_kwargs
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._startup_error: BaseException | None = None
        self.server: Server | None = None
        self.address: str = ""

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="kcp-tpu-server")
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("server thread failed to start in time")
        if self._startup_error is not None:
            self._thread.join(timeout=5)
            raise RuntimeError("server startup failed") from self._startup_error
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            await self.server.start()
            self.address = self.server.address
            self._started.set()
            await self.server._stop.wait()
            await self.server.shutdown()

        try:
            # construct INSIDE the try: a constructor failure (bad
            # config, missing TLS dependency) must surface through
            # _startup_error immediately, not leave start() waiting out
            # its whole timeout on a thread that already died
            self.server = Server(self._config, **self._server_kwargs)
            self._loop.run_until_complete(main())
        except BaseException as e:  # surfaced to start() — not swallowed
            self._startup_error = e
        finally:
            self._loop.close()
            self._started.set()  # unblock start() on failure paths

    @property
    def ca_pem(self) -> bytes | None:
        """The serving CA (None when TLS off) for RestClient(ca_data=...)."""
        return self.server.ca_pem if self.server else None

    def submit(self, coro):
        """Run a coroutine on the server loop, return its result."""
        assert self._loop is not None
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(30)

    def call(self, fn, *args, **kwargs):
        """Run a plain callable on the server loop thread (store access)."""

        async def _wrap():
            return fn(*args, **kwargs)

        return self.submit(_wrap())

    def drain(self, timeout: float | None = None) -> None:
        """Graceful stop (the SIGTERM path for embedded servers): run
        Server.drain on the server loop — stop accepting, finish
        in-flight requests, terminal Status to live watchers, flush
        replication — then stop. Bounded by KCP_DRAIN_TIMEOUT_S."""
        if self._loop is not None and self.server is not None:
            try:
                self.submit(self.server.drain(timeout))
            except Exception:  # noqa: BLE001 — loop already down: a drain
                pass  # racing a kill/stop degrades to the plain stop below
        self.stop()

    def kill(self) -> None:
        """Abrupt stop (SIGKILL emulation for kill drills): no WAL
        compaction, in-flight streams die mid-chunk. See Server.kill."""
        if self._loop is not None and self.server is not None:
            try:
                self._loop.call_soon_threadsafe(self.server.kill)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def stop(self) -> None:
        if self._loop is not None and self.server is not None:
            try:
                self._loop.call_soon_threadsafe(self.server.stop)
            except RuntimeError:
                pass  # loop already closed: stop() is idempotent (chaos
                # harnesses kill a shard mid-test and the fixture stops
                # every thread again on teardown)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
