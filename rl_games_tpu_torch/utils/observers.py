"""Algo observers: the callback bus for custom metrics.

Port of rl_games_tpu/utils/observers.py (the reference's
common/algo_observer.py). The JAX package moved per-step score extraction
onto the device and hands observers aggregated metrics once per epoch; the
port keeps that hook surface. ``PPOAgent.train`` calls ``before_init`` and
``after_init`` once, then ``after_epoch(metrics)`` and
``after_print_stats(frame, epoch, total_time)`` on every log epoch, with
``metrics`` as host values; ``after_clear_stats`` follows
``PPOAgent.clear_stats``. ``process_infos`` and ``after_steps`` are the
host-env path's hooks (ROADMAP.md, item A11).
"""


class AlgoObserver:
    """algo_observer.py:6-26 hook surface."""

    def before_init(self, base_name, config, experiment_name):
        pass

    def after_init(self, algo):
        pass

    def process_infos(self, infos, done_indices):
        """Host-path only: called when infos are host-visible."""

    def after_steps(self):
        pass

    def after_epoch(self, metrics: dict):
        """Aggregated metrics once per log epoch."""

    def after_clear_stats(self):
        pass

    def after_print_stats(self, frame, epoch_num, total_time):
        pass


class DefaultAlgoObserver(AlgoObserver):
    """Scores tracking (algo_observer.py:29-92): envs that report
    infos['scores'] get a scores/* scalar family from metrics['mean_scores']."""

    def __init__(self):
        self.writer = None
        self.mean_scores = None

    def after_init(self, algo):
        self.algo = algo
        self.writer = getattr(algo, "writer", None)

    def after_epoch(self, metrics):
        if "mean_scores" in metrics:
            self.mean_scores = float(metrics["mean_scores"])

    def after_print_stats(self, frame, epoch_num, total_time):
        if self.writer is not None and self.mean_scores is not None:
            self.writer.add_scalar("scores/mean", self.mean_scores, frame)
            self.writer.add_scalar("scores/iter", self.mean_scores, epoch_num)
            self.writer.add_scalar("scores/time", self.mean_scores, int(total_time))


class IsaacAlgoObserver(AlgoObserver):
    """Isaac-style episode metrics (algo_observer.py:95-156): envs report
    `infos['episode']` dicts at episode end and scalar direct-info keys;
    per-key means land under `Episode/<key>`, direct scalars under
    `<key>/frame|iter|time`. Fed by process_infos on the host path."""

    def __init__(self):
        self.ep_infos = []
        self.direct_info = {}
        self.writer = None

    def after_init(self, algo):
        self.algo = algo
        self.writer = getattr(algo, "writer", None)

    def process_infos(self, infos, done_indices):
        if not isinstance(infos, dict):
            raise ValueError(
                f"{type(self).__name__} expected 'infos' as dict; got {type(infos)}"
            )
        if infos.get("episode"):
            self.ep_infos.append(infos["episode"])
        self.direct_info = {}
        for k, v in infos.items():
            if isinstance(v, (int, float)):
                self.direct_info[k] = float(v)
            elif getattr(v, "ndim", None) == 0:
                self.direct_info[k] = float(v)

    def after_clear_stats(self):
        self.ep_infos.clear()

    def after_print_stats(self, frame, epoch_num, total_time):
        import numpy as np

        if self.writer is None:
            return
        if self.ep_infos:
            all_keys = set().union(*self.ep_infos)
            for key in sorted(all_keys):
                vals = [
                    np.asarray(e[key], np.float32).reshape(-1)
                    for e in self.ep_infos
                    if key in e
                ]
                value = float(np.concatenate(vals).mean())
                self.writer.add_scalar("Episode/" + key, value, epoch_num)
            self.ep_infos.clear()
        for k, v in self.direct_info.items():
            self.writer.add_scalar(f"{k}/frame", v, frame)
            self.writer.add_scalar(f"{k}/iter", v, epoch_num)
            self.writer.add_scalar(f"{k}/time", v, int(total_time))


class MultiObserver(AlgoObserver):
    """Compose observers (pbt.py:275-302)."""

    def __init__(self, observers):
        self.observers = [o for o in observers if o is not None]

    def _call(self, name, *args, **kwargs):
        for o in self.observers:
            getattr(o, name)(*args, **kwargs)

    def before_init(self, *a, **k):
        self._call("before_init", *a, **k)

    def after_init(self, *a, **k):
        self._call("after_init", *a, **k)

    def process_infos(self, *a, **k):
        self._call("process_infos", *a, **k)

    def after_steps(self, *a, **k):
        self._call("after_steps", *a, **k)

    def after_epoch(self, *a, **k):
        self._call("after_epoch", *a, **k)

    def after_clear_stats(self, *a, **k):
        self._call("after_clear_stats", *a, **k)

    def after_print_stats(self, *a, **k):
        self._call("after_print_stats", *a, **k)
