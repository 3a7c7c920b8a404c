"""AQORA decision model: state encoding, plan actions, TreeCNN
actor-critic (nets.py, agent.py), host-side PRNG keys and rollouts."""
