"""``MonitoredTrainingSession`` and ``Scaffold`` (ref: tensorflow/python/
training/monitored_session.py); the port of ``simple_tensorflow_tpu/
train/monitored_session.py``: ``Scaffold``, ``SessionManager``,
``ChiefSessionCreator``, ``WorkerSessionCreator``, ``MonitoredSession``,
``SingularMonitoredSession`` and ``MonitoredTrainingSession``.

Hooks observe every run; a session is restored from the latest
checkpoint of ``checkpoint_dir`` when there is one, else initialized.
Under ``ConfigProto(loop_fusion_steps=N)`` a ``run`` is a window of up to
N steps (``Session.run_steps``, ``"last"`` outputs), and ``run_steps(
fetches, n)`` runs n steps in windows; each window is capped by every
hook's ``until_next_trigger`` vote (``_fusion_window``), so a hook that
triggers at step K observes the values of step K. On the card a window
whose plan is loop-safe is n replays of the step's CUDA graph.

Differences: ``Scaffold`` builds no ``report_uninitialized_variables``
op (not ported): after a restore, only the variables the checkpoint did
not cover (none, with the scaffold's own ``Saver``) are initialized,
where the JAX session manager runs the whole initializer again. When the
resolved numerics mode is not off, a ``NumericsHealthHook`` is added
(``train/health.py``), as in JAX.
"""

from __future__ import annotations

from ..client.session import Session
from ..framework import graph as ops_mod
from ..ops import control_flow_ops
from ..ops import variables as variables_mod
from . import basic_session_run_hooks
from . import session_run_hook
from . import training_util
from .coordinator import Coordinator
from .saver import Saver, latest_checkpoint

class Scaffold:
    """(ref: monitored_session.py:60 ``class Scaffold``)."""

    def __init__(self, init_op=None, init_feed_dict=None, init_fn=None,
                 ready_op=None, ready_for_local_init_op=None,
                 local_init_op=None, summary_op=None, saver=None,
                 copy_from_scaffold=None):
        self._init_op = init_op
        self._init_feed_dict = init_feed_dict
        self._init_fn = init_fn
        self._ready_op = ready_op
        self._local_init_op = local_init_op
        self._summary_op = summary_op
        self._saver = saver
        self._finalized = False

    def finalize(self):
        if self._finalized:
            return self
        g = ops_mod.get_default_graph()
        if self._init_op is None:
            self._init_op = control_flow_ops.group(
                variables_mod.global_variables_initializer(),
                variables_mod.local_variables_initializer(),
                name="scaffold_init")
        if self._local_init_op is None:
            self._local_init_op = variables_mod.local_variables_initializer()
        if self._summary_op is None:
            from ..summary import summary as summary_mod

            self._summary_op = summary_mod.merge_all()
        if self._saver is None:
            savers = g.get_collection(ops_mod.GraphKeys.SAVERS)
            self._saver = savers[0] if savers else Saver()
        self._finalized = True
        return self

    @property
    def init_op(self):
        return self._init_op

    @property
    def init_feed_dict(self):
        return self._init_feed_dict

    @property
    def init_fn(self):
        return self._init_fn

    @property
    def ready_op(self):
        return self._ready_op

    @property
    def local_init_op(self):
        return self._local_init_op

    @property
    def summary_op(self):
        return self._summary_op

    @property
    def saver(self):
        return self._saver


def _uninitialized(sess):
    """The global and local variables of the session's graph with no value
    in its store."""
    g, store = sess.graph, sess._variable_store.values
    return [v for v in (g.get_collection(ops_mod.GraphKeys.GLOBAL_VARIABLES)
                        + g.get_collection(ops_mod.GraphKeys.LOCAL_VARIABLES))
            if v.var_name not in store]


class SessionManager:
    """(ref: tensorflow/python/training/session_manager.py)."""

    def __init__(self, local_init_op=None, ready_op=None,
                 ready_for_local_init_op=None, graph=None,
                 recovery_wait_secs=0.5):
        self._graph = graph or ops_mod.get_default_graph()

    def prepare_session(self, master="", init_op=None, saver=None,
                        checkpoint_dir=None,
                        checkpoint_filename_with_path=None,
                        wait_for_checkpoint=False, max_wait_secs=7200,
                        config=None, init_feed_dict=None, init_fn=None):
        sess = Session(master, graph=self._graph, config=config)
        path = checkpoint_filename_with_path
        if saver is not None and path is None and checkpoint_dir:
            path = latest_checkpoint(checkpoint_dir)
        if saver is not None and path:
            saver.restore(sess, path)
            missing = _uninitialized(sess)
            if missing:
                sess.run(variables_mod.variables_initializer(missing))
            return sess
        if init_op is not None:
            sess.run(init_op, feed_dict=init_feed_dict)
        if init_fn is not None:
            init_fn(sess)
        return sess

    def recover_session(self, master="", saver=None, checkpoint_dir=None,
                        checkpoint_filename_with_path=None,
                        wait_for_checkpoint=False, max_wait_secs=7200,
                        config=None):
        sess = Session(master, graph=self._graph, config=config)
        path = checkpoint_filename_with_path or (
            latest_checkpoint(checkpoint_dir) if checkpoint_dir else None)
        if path and saver is not None:
            saver.restore(sess, path)
            return sess, True
        return sess, False

    def wait_for_session(self, master="", config=None, max_wait_secs=None):
        return Session(master, graph=self._graph, config=config)


class SessionCreator:
    def create_session(self):
        raise NotImplementedError


class ChiefSessionCreator(SessionCreator):
    """(ref: monitored_session.py:402)."""

    def __init__(self, scaffold=None, master="", config=None,
                 checkpoint_dir=None, checkpoint_filename_with_path=None):
        self._scaffold = scaffold or Scaffold()
        self._master = master
        self._config = config
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_filename_with_path = checkpoint_filename_with_path

    def create_session(self):
        self._scaffold.finalize()
        return SessionManager().prepare_session(
            self._master, init_op=self._scaffold.init_op,
            saver=self._scaffold.saver, checkpoint_dir=self._checkpoint_dir,
            checkpoint_filename_with_path=self._checkpoint_filename_with_path,
            config=self._config,
            init_feed_dict=self._scaffold.init_feed_dict,
            init_fn=self._scaffold.init_fn)


class WorkerSessionCreator(SessionCreator):
    """(ref: monitored_session.py:451): workers initialize as the chief
    does (one process, one card)."""

    def __init__(self, scaffold=None, master="", config=None,
                 max_wait_secs=30 * 60):
        self._inner = ChiefSessionCreator(scaffold, master, config)

    def create_session(self):
        return self._inner.create_session()


class _MonitoredSession:
    """(ref: monitored_session.py:537 ``class _MonitoredSession``)."""

    def __init__(self, session_creator, hooks, should_recover,
                 stop_grace_period_secs=120):
        self._hooks = list(hooks or [])
        self._coord = Coordinator()
        for h in self._hooks:
            h.begin()
        self._sess = session_creator.create_session()
        for h in self._hooks:
            h.after_create_session(self._sess, self._coord)
        self._should_close = True

    @property
    def graph(self):
        return self._sess.graph

    @property
    def raw_session(self):
        return self._sess

    def run(self, fetches, feed_dict=None, options=None, run_metadata=None):
        cfg = getattr(self._sess, "_config", None)
        cap = getattr(cfg, "loop_fusion_steps", 1) if cfg is not None else 1
        if cap > 1:
            # a window of up to loop_fusion_steps steps, capped by every
            # hook's vote so no hook misses the step it must observe
            return self._run_once(fetches, feed_dict, options, run_metadata,
                                  window=self._fusion_window(cap))
        return self._run_once(fetches, feed_dict, options, run_metadata)

    def run_steps(self, fetches, n, feed_dict=None, options=None):
        """Run ``n`` training steps through the hooked session in windows
        (``Session.run_steps``) split at the hooks' trigger steps; returns
        the last window's fetches (None when a hook stopped the session
        before any step ran)."""
        last = None
        done = 0
        while done < n and not self.should_stop():
            w = min(n - done, self._fusion_window(n - done))
            last = self._run_once(fetches, feed_dict, options, None,
                                  window=w)
            done += w
        return last

    def _fusion_window(self, cap):
        gs = self._current_global_step()
        w = max(1, int(cap))
        for h in self._hooks:
            w = min(w, max(1, int(h.until_next_trigger(gs))))
        return w

    def _current_global_step(self):
        """``global_step`` read from the store (no run); 0 while it is
        not initialized."""
        gs_t = training_util.get_global_step(self._sess.graph)
        if gs_t is None:
            return 0
        try:
            return int(self._sess.variable_value(gs_t).item())
        except KeyError:
            return 0

    def _run_once(self, fetches, feed_dict=None, options=None,
                  run_metadata=None, window=1):
        feeds = dict(feed_dict or {})
        actual_fetches = {"caller": fetches}
        run_context = session_run_hook.SessionRunContext(
            original_args=session_run_hook.SessionRunArgs(fetches,
                                                          feed_dict),
            session=self._sess)
        hook_fetches = {}
        for i, h in enumerate(self._hooks):
            req = h.before_run(run_context)
            if req is None:
                continue
            if req.fetches is not None:
                hook_fetches[i] = req.fetches
            if req.feed_dict:
                feeds.update(req.feed_dict)
        actual_fetches["hooks"] = hook_fetches
        if window > 1:
            # the hooks voted this window safe: they observe its last
            # step's values (an unsafe plan runs step by step inside)
            results = self._sess.run_steps(actual_fetches, n=window,
                                           feed_dict=feeds,
                                           output_mode="last")
        else:
            results = self._sess.run(actual_fetches, feed_dict=feeds)
        for i, h in enumerate(self._hooks):
            h.after_run(run_context, session_run_hook.SessionRunValues(
                results=results["hooks"].get(i), options=options,
                run_metadata=run_metadata))
        if run_context.stop_requested:
            self._coord.request_stop()
        return results["caller"]

    def run_step_fn(self, step_fn):
        monitored = self

        class StepContext:
            def __init__(self, session):
                self.session = session

            def run_with_hooks(self, fetches, feed_dict=None):
                return monitored.run(fetches, feed_dict)

            def request_stop(self):
                monitored._coord.request_stop()

        return step_fn(StepContext(self._sess))

    def should_stop(self):
        return self._coord.should_stop()

    def close(self):
        self._close_internal()

    def _close_internal(self):
        try:
            for h in self._hooks:
                h.end(self._sess)
        finally:
            self._coord.request_stop()
            if self._should_close:
                self._sess.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._close_internal()
        return False


class MonitoredSession(_MonitoredSession):
    """(ref: monitored_session.py:737)."""

    def __init__(self, session_creator=None, hooks=None,
                 stop_grace_period_secs=120):
        super().__init__(session_creator or ChiefSessionCreator(), hooks,
                         should_recover=True,
                         stop_grace_period_secs=stop_grace_period_secs)


class SingularMonitoredSession(_MonitoredSession):
    """(ref: monitored_session.py:797)."""

    def __init__(self, hooks=None, scaffold=None, master="", config=None,
                 checkpoint_dir=None, stop_grace_period_secs=120,
                 checkpoint_filename_with_path=None):
        super().__init__(
            ChiefSessionCreator(scaffold, master, config, checkpoint_dir,
                                checkpoint_filename_with_path),
            hooks, should_recover=False,
            stop_grace_period_secs=stop_grace_period_secs)


def MonitoredTrainingSession(master="", is_chief=True, checkpoint_dir=None,
                             scaffold=None, hooks=None,
                             chief_only_hooks=None,
                             save_checkpoint_secs=600,
                             save_checkpoint_steps=None,
                             save_summaries_steps=100,
                             save_summaries_secs=None, config=None,
                             stop_grace_period_secs=120,
                             log_step_count_steps=100,
                             max_wait_secs=7200, save_on_preemption=True):
    """(ref: monitored_session.py:256 ``MonitoredTrainingSession``). With a
    ``checkpoint_dir`` the chief also gets a ``PreemptionHandler``
    (SIGTERM: finish the window, save, stop), a ``CheckpointSaverHook``,
    a ``StepCounterHook`` and a ``SummarySaverHook``; on a restart the
    same call restores the latest checkpoint (variables, optimizer slots,
    ``global_step``, the RNG run counter)."""
    scaffold = scaffold or Scaffold()
    all_hooks = list(hooks or [])
    # the numerics plane runs in the Session; the hook adds its log
    from . import health as health_mod

    if health_mod.resolved_mode(config) != "off" and not any(
            isinstance(h, health_mod.NumericsHealthHook)
            for h in all_hooks):
        all_hooks.append(health_mod.NumericsHealthHook())
    if is_chief:
        session_creator = ChiefSessionCreator(scaffold, master, config,
                                              checkpoint_dir)
        if chief_only_hooks:
            all_hooks.extend(chief_only_hooks)
        if checkpoint_dir:
            if save_on_preemption:
                from ..checkpoint.preemption import PreemptionHandler

                all_hooks.append(PreemptionHandler(
                    checkpoint_dir=checkpoint_dir, scaffold=scaffold))
            if save_checkpoint_steps and save_checkpoint_steps > 0:
                all_hooks.append(basic_session_run_hooks.CheckpointSaverHook(
                    checkpoint_dir, save_steps=save_checkpoint_steps,
                    scaffold=scaffold))
            elif save_checkpoint_secs and save_checkpoint_secs > 0:
                all_hooks.append(basic_session_run_hooks.CheckpointSaverHook(
                    checkpoint_dir, save_secs=save_checkpoint_secs,
                    scaffold=scaffold))
            if log_step_count_steps and log_step_count_steps > 0:
                all_hooks.append(basic_session_run_hooks.StepCounterHook(
                    every_n_steps=log_step_count_steps,
                    output_dir=checkpoint_dir))
            if (save_summaries_steps and save_summaries_steps > 0) or \
                    (save_summaries_secs and save_summaries_secs > 0):
                all_hooks.append(basic_session_run_hooks.SummarySaverHook(
                    save_steps=save_summaries_steps,
                    save_secs=save_summaries_secs, scaffold=scaffold,
                    output_dir=checkpoint_dir))
    else:
        session_creator = WorkerSessionCreator(scaffold, master, config,
                                               max_wait_secs)
    return MonitoredSession(session_creator=session_creator, hooks=all_hooks,
                            stop_grace_period_secs=stop_grace_period_secs)
