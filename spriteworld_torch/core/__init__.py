"""Engine core: state, distributions, generators, actions, tasks, env."""
