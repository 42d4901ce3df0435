from vlnce_torch.tasks import actions, datasets, measures, sensors  # noqa: F401  (registry population)
