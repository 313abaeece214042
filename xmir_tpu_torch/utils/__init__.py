from .checkpoint import BestCheckpointPolicy, checkpoint_name, load_checkpoint, save_checkpoint
