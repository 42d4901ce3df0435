"""Teacher-forcing trainer over re-simulated GT trajectories (the RxR
baselines' recipe), port of vlnce_tpu/trainers/recollect_trainer.py
(reference vlnce_baselines/recollect_trainer.py:28-219).

No disk cache: every epoch the sim pool re-renders the GT trajectories
(`data/recollection.TeacherRecollectionDataset`, stepped on the prefetch
thread so that re-simulation overlaps the train step). Per batch: one pinned
upload per array, the obs transforms on the flat [T*N, ...] frames on the
policy's device (on the card, two launches of the resize kernel over every
collated frame, padding included), the reshape to time-major [T, N, ...],
then the IL accumulation step of `parallel/il_step.py`. Gradients accumulate
over `effective_batch_size / IL.batch_size` batches before each masked Adam
step. Every epoch writes `ckpt.{epoch}.ckpt` with its optimizer state.

With `CUDA.ON_DEVICE_RECOLLECT` the GT trajectories are rendered on the card
(`trainers/device_recollect.py`, no env pool) and come back through the same
collate and upload. With `CUDA.RECOLLECT_RESIDENT` as well, each batch is
rendered on the card with its obs transforms (B2 inside the render step)
and stays there: the accumulation step takes it as it is, time-major.
Across ranks (`self.mesh`) each rank re-simulates its own episodes and the
accumulated gradients are summed over the ranks in the step that applies
them (`parallel/il_step.build_il_accum_step`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from vlnce_torch.data.prefetch import PrefetchIterator
from vlnce_torch.data.recollection import TeacherRecollectionDataset
from vlnce_torch.parallel.il_step import build_il_accum_step
from vlnce_torch.registry import registry
from vlnce_torch.trainers.base_trainer import BaseVLNCETrainer
from vlnce_torch.utils.checkpoints import wait_for_pending
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import StepClock
from vlnce_torch.utils.progress import tqdm
from vlnce_torch.utils.tensorboard import TensorboardWriter


@registry.register_trainer(name="recollect_trainer")
class RecollectTrainer(BaseVLNCETrainer):
    # set before `train()` to have every train step split by the device's
    # clock into `step_clock` (upload, forward, backward, optimizer), as
    # DaggerTrainer does
    time_train_steps = False

    def __init__(self, config):
        super().__init__(config)
        self._steps: Dict[bool, object] = {}  # the accumulation step by its apply flag
        # every batch's (epoch, loss, action_loss, aux_loss), and the
        # dataset's re-simulation counts of the run
        self.loss_history: List[Tuple[int, float, float, float]] = []
        self.resimulation: Dict[str, float] = {}
        self._resident = False  # batches rendered on the card and kept there

    def train(self) -> None:
        config = self.config.defrost()
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.IL.RECOLLECT_TRAINER.gt_path = config.IL.RECOLLECT_TRAINER.gt_file
        config.freeze()
        self.config = config

        dataset = TeacherRecollectionDataset(config)
        self._resident = dataset.resident
        self.obs_transforms = dataset.obs_transforms
        self._initialize_policy(
            config,
            load_from_ckpt=config.IL.load_from_ckpt,
            observation_space=dataset.observation_space,
            action_space=dataset.action_space,
        )
        self.step_clock = StepClock(self.policy.device) if self.time_train_steps else None

        effective = config.IL.RECOLLECT_TRAINER.effective_batch_size
        accumulation = 1
        if effective > 0:
            assert effective % config.IL.batch_size == 0
            accumulation = effective // config.IL.batch_size

        self.optimizer.zero_grad(set_to_none=True)
        os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
        batches_per_epoch = int(np.ceil(dataset.length / dataset.batch_size))

        with TensorboardWriter(config.TENSORBOARD_DIR, purge_step=0) as writer:
            for epoch in range(self.start_epoch, config.IL.epochs):
                t_epoch = time.time()
                losses = []
                # live re-simulation runs on the prefetch thread, overlapping
                # the sims' stepping with the train step (IL.prefetch_batches;
                # the reference's DataLoader worker, recollect_trainer.py:86)
                batches = PrefetchIterator(dataset.batches(batches_per_epoch), depth=config.IL.prefetch_batches)
                for batch_idx, batch in enumerate(
                    tqdm(batches, total=batches_per_epoch, desc=f"epoch {epoch}", dynamic_ncols=True)
                ):
                    apply = accumulation == 1 or (batch_idx + 1) % accumulation == 0
                    loss, action_loss, aux_loss = self._update_agent(*batch, apply=apply, accumulation=accumulation)
                    losses.append(loss)
                    self.loss_history.append((epoch, loss, action_loss, aux_loss))
                    writer.add_scalar("train_loss", loss, self.step_id)
                    writer.add_scalar("train_action_loss", action_loss, self.step_id)
                    writer.add_scalar("train_aux_loss", aux_loss, self.step_id)
                    self.step_id += 1

                logger.info(f"[recollect epoch {epoch}] mean_loss={np.mean(losses):.4f} took {time.time() - t_epoch:.1f}s")
                self.save_checkpoint(f"ckpt.{epoch}.ckpt", extra_state={"epoch": epoch, "step_id": self.step_id})
        self.resimulation = dict(dataset.sim_stats)
        dataset.close_sims()
        # join any in-flight async checkpoint write: callers may load the
        # last checkpoint the moment train() returns
        wait_for_pending()

    def _update_agent(self, observations, prev_actions, masks, corrected, weights, apply: bool,
                      accumulation: int) -> Tuple[float, float, float]:
        """One accumulation step on a collated batch (see `_il_update`); with
        `apply`, the optimizer steps after it."""
        if apply not in self._steps:
            clock = self.step_clock
            accum_step = build_il_accum_step(self.policy, self.optimizer, apply, mesh=self.mesh,
                                             **({"mark": clock.mark} if clock else {}))
            self._steps[apply] = lambda *batch: accum_step(float(accumulation), *batch)
        return self._il_update(self._steps[apply], observations, prev_actions, masks, corrected, weights)
