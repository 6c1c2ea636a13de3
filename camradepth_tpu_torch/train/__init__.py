"""Single-device training of the port: losses, the diffGradNorm optimizer,
the OneCycle schedule, the train and eval steps and the trainer."""
