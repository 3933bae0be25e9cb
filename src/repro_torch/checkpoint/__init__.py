from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
