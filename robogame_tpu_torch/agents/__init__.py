"""Team agents: the classical team state machine."""
