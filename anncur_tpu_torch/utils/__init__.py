from anncur_tpu_torch.utils.tracker import ExperimentTracker, StageTimer, trace_profile  # noqa: F401
