"""Examples of the port that run as modules
(``python3 -m crocoddyl_tpu_torch.examples.<name>``)."""
