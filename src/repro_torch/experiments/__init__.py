"""The paper's experiment runners in the port: `main_experiment` (AQORA
beside Spark default, Lero and AutoSteer, Fig. 7) and `ablations` (the
DQN agent and the encoder, strategy, action-space and dynamic-data
ablations, Fig. 9, Fig. 11, Tab. III)."""
