"""Metrics writing: TensorBoard scalar families + interval throttling.

Port of rl_games_tpu/utils/writer.py. Scalar names mirror the reference
exactly (write_stats, a2c_common.py:396-416 and train-loop writes
:1404-1443) so dashboards carry over: performance/*, losses/*, info/*,
rewards{i}/*, shaped_rewards{i}/*, episode_lengths/*.

IntervalSummaryWriter is the PBT-scale throttle (interval_summary_writer.py:
4-66): adaptive interval ≈ run_time/200 clamped to [5s, 300s].
"""

import time
from typing import Optional


class NoopWriter:
    def add_scalar(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def create_writer(summaries_dir: Optional[str]):
    if summaries_dir is None:
        return NoopWriter()
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(summaries_dir)
    except Exception:
        return NoopWriter()


class IntervalSummaryWriter:
    """interval_summary_writer.py:4-66."""

    def __init__(self, writer, config: dict = None):
        config = config or {}
        self.writer = writer
        # reference config keys (interval_summary_writer.py:21-25)
        self.defer_summaries_sec = config.get("defer_summaries_sec", 5)
        self.min_interval = config.get("summaries_interval_sec_min", 5)
        self.max_interval = config.get("summaries_interval_sec_max", 300)
        self.summary_every_sec = self.min_interval
        self.interval_frac = 1.0 / 200
        self.start_time = time.time()
        self.last_write = 0.0
        self._note_write = False

    def _update_interval(self):
        run_time = time.time() - self.start_time
        self.summary_every_sec = min(
            max(run_time * self.interval_frac, self.min_interval),
            self.max_interval,
        )

    def add_scalar(self, tag, value, step):
        if step == 0:
            # faulty summaries after an experiment restart
            # (interval_summary_writer.py:48-51)
            return
        now = time.time()
        if now - self.start_time < self.defer_summaries_sec:
            return
        if now - self.last_write >= self.summary_every_sec:
            self.writer.add_scalar(tag, value, step)
            self._note_write = True

    def tick(self):
        """Call once per epoch after the scalar batch."""
        if self._note_write:
            self.last_write = time.time()
            self._note_write = False
            self._update_interval()

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


def write_ppo_stats(writer, metrics: dict, frame: int, epoch: int,
                    total_time: float, fps_total: float, fps_step: float,
                    value_size: int = 1, fps_inference: float = None):
    """The reference scalar families (a2c_common.py:396-416, 1404-1443).
    ``metrics`` holds host values (numpy or Python scalars)."""
    w = writer.add_scalar
    w("performance/step_inference_rl_update_fps", fps_total, frame)
    w("performance/step_inference_fps",
      fps_step if fps_inference is None else fps_inference, frame)
    w("performance/step_fps", fps_step, frame)
    w("losses/a_loss", float(metrics["a_loss"]), frame)
    w("losses/c_loss", float(metrics["c_loss"]), frame)
    w("losses/entropy", float(metrics["entropy"]), frame)
    if "b_loss" in metrics:
        w("losses/bounds_loss", float(metrics["b_loss"]), frame)
    w("info/last_lr", float(metrics["lr"]), frame)
    w("info/e_clip", float(metrics.get("e_clip", 0.0)), frame)
    w("info/kl", float(metrics["kl"]), frame)
    w("info/epochs", epoch, frame)
    if "clip_frac" in metrics:
        w("info/clip_frac", float(metrics["clip_frac"]), frame)

    games_played = int(metrics.get("games_played", 0))
    if games_played > 0:
        mean_rewards = metrics["mean_rewards"]
        mean_shaped = metrics.get("mean_shaped_rewards", mean_rewards)
        for i in range(value_size):
            rk = "rewards" if value_size == 1 else f"rewards{i}"
            sk = "shaped_" + rk
            w(f"{rk}/step", float(mean_rewards[i]), frame)
            w(f"{rk}/iter", float(mean_rewards[i]), epoch)
            w(f"{rk}/time", float(mean_rewards[i]), int(total_time))
            w(f"{sk}/step", float(mean_shaped[i]), frame)
            w(f"{sk}/iter", float(mean_shaped[i]), epoch)
            w(f"{sk}/time", float(mean_shaped[i]), int(total_time))
        w("episode_lengths/step", float(metrics["mean_lengths"]), frame)
        w("episode_lengths/iter", float(metrics["mean_lengths"]), epoch)
        w("episode_lengths/time", float(metrics["mean_lengths"]), int(total_time))
