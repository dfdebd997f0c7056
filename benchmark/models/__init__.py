"""The benchmark's models, one module each, found by a configuration's
`model`. A model module gives what a traffic kind needs of it:

  init_values(config, data, seed)   every leaf's initial value (the
                                    benchmark's inputs, nothing of the program)
  train_batch(data, device)         (ys, ts, shapes) of one train step
  train_noise(config, shapes, gen, device)   every random number of a step
  build_params(config, data, values, device) the program's parameters
  train_step(config, params, ys, ts)         the program's step object
  predict_scorer(config, data, split, device) the program's scorer, where
                                    the model serves prediction requests
"""
