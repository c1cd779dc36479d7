version = '0.3.0'
nickname = 'butte'

author = 'supervillain-tpu developers'
description = (
    'Accelerator lattice Monte Carlo for the Villain model of the compact boson, '
    'in the Villain and Worldline dual formulations with a Z_W vortex constraint.'
)
