"""A run with the timed path broken underneath comes out not correct:
the rest of a run (runners, reference, checks, limits) at a small size on
the CPU, with one fault planted in the program for each fault a cell can
have. Each cell has one chip, so the exchange between chips is not one of
them."""

import pytest
import torch

from benchmark.tests import small

ROLLOUT, TRAIN = "rxr_cma.scan_rollout", "r2r_cma.dagger_train"


def _failed_on(compared, name):
    return compared[name]["value"] > compared[name]["limit"]


def test_sound_runs_are_correct():
    for workload in (ROLLOUT, TRAIN):
        assert small.run(workload)[2]


def test_rollout_whose_step_leaves_the_pose_unchanged(monkeypatch):
    from vlnce_torch.trainers import scan_eval

    monkeypatch.setattr(scan_eval, "step_batch", lambda scenes, pos, heading, *args: (pos, heading))
    _, compared, correct = small.run(ROLLOUT)
    assert not correct and _failed_on(compared, "final_logit_rel")


def _mode_patch(monkeypatch, change):
    from vlnce_torch.trainers import scan_eval

    class Broken(scan_eval.Categorical):
        def mode(self):
            return change(super().mode())

    monkeypatch.setattr(scan_eval, "Categorical", Broken)


def test_rollout_that_leaves_half_the_batch_out(monkeypatch):
    def half(a):
        a = a.clone()
        a[a.shape[0] // 2 :] = 0  # those rows never step: they stop at once
        return a

    _mode_patch(monkeypatch, half)
    _, compared, correct = small.run(ROLLOUT)
    assert not correct and _failed_on(compared, "stopped_early")


def test_rollout_with_an_answer_altered_where_it_is_made(monkeypatch):
    from vlnce_torch.trainers import scan_eval

    run = scan_eval.ScanSegment.run

    def altered(self, generator=None):
        actions, done = run(self, generator)
        actions = actions.copy()
        actions[1, 0] = actions[1, 0] % 5 + 1  # the first episode's second action as read back, never STOP
        return actions, done

    monkeypatch.setattr(scan_eval.ScanSegment, "run", altered)
    _, compared, correct = small.run(ROLLOUT)
    assert not correct and _failed_on(compared, "final_logit_rel")


def test_rollout_that_commits_a_wrong_action_in_one_row(monkeypatch):
    def one_row_off(a):
        a = a.clone()
        a[0] = a[0] % 5 + 1  # the first row keeps stepping, on the next action after its best (never STOP)
        return a

    _mode_patch(monkeypatch, one_row_off)
    _, compared, correct = small.run(ROLLOUT)
    assert not correct and _failed_on(compared, "widest_gap_rel")
    assert compared["stopped_early"]["value"] == 0


def test_rollout_that_switches_tf32_on(monkeypatch):
    from vlnce_torch.trainers import scan_eval

    run = scan_eval.run_scan_rollouts
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # put back after the test

    def with_tf32(*args, **kwargs):
        torch.backends.cuda.matmul.allow_tf32 = True
        return run(*args, **kwargs)

    monkeypatch.setattr(scan_eval, "run_scan_rollouts", with_tf32)
    _, compared, correct = small.run(ROLLOUT)
    assert not correct and _failed_on(compared, "tf32_switched_on")


def test_training_that_switches_tf32_on(monkeypatch):
    from vlnce_torch.data import device_bank

    run = device_bank.run_fused_epoch
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # put back after the test

    def with_tf32(*args, **kwargs):
        torch.backends.cuda.matmul.allow_tf32 = True
        return run(*args, **kwargs)

    monkeypatch.setattr(device_bank, "run_fused_epoch", with_tf32)
    _, compared, correct = small.run(TRAIN)
    assert not correct and _failed_on(compared, "tf32_switched_on")


def test_training_step_that_leaves_the_parameters_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *args, **kwargs):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    _, compared, correct = small.run(TRAIN)
    assert not correct and compared["update_gap_median"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch(monkeypatch):
    from vlnce_torch.parallel import il_step

    terms = il_step.il_loss_terms

    def half(policy, obs_tn, prev_tn, masks_tn, corrected, weights):
        n = corrected.shape[1] // 2
        return terms(policy, {k: v[:, :n] for k, v in obs_tn.items()}, prev_tn[:, :n], masks_tn[:, :n], corrected[:, :n],
                     weights[:, :n])

    monkeypatch.setattr(il_step, "il_loss_terms", half)
    _, compared, correct = small.run(TRAIN)
    assert not correct and _failed_on(compared, "loss_gap")


def test_training_with_a_label_altered_where_it_is_gathered(monkeypatch):
    from vlnce_torch.data import device_bank

    gather = device_bank.gather_core

    def altered(*args, **kwargs):
        obs, prev, masks, corrected, weights = gather(*args, **kwargs)
        corrected = corrected.clone()
        corrected[0, 0] = (corrected[0, 0] + 1) % 4
        return obs, prev, masks, corrected, weights

    monkeypatch.setattr(device_bank, "gather_core", altered)
    _, compared, correct = small.run(TRAIN)
    assert not correct and _failed_on(compared, "loss_gap")
